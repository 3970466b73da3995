// Shared online-softmax attention core for the three hand-written Hopper
// kernels (flash forward, SAM window attention, SAM global rel-pos
// attention).
//
// One CTA owns BQ = 64 query rows of one (batch*head) row and runs 4 warps,
// each warp 16 query rows. Q stays in registers as mma.sync A fragments for
// the whole key loop; K and V are staged BK = 64 keys at a time in shared
// memory; S = Q K^T and O += P V run on bf16 mma.sync.m16n8k16 with f32
// accumulation; the running max / sum / output accumulator live in f32
// registers (the Pallas kernels' online softmax). Ragged edges (query rows
// past Lq, keys past Lk, head dims that are not powers of two such as 80)
// are masked in-kernel, never padded on the host.
//
// The additive bias is a functor evaluated per (row, key) from tables the
// calling kernel staged in shared memory before entering the core.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ivlm {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) |
         (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

// acc + the dot product of two pairs of bf16 (packed as by pack_bf16), in
// f32, in order
__device__ __forceinline__ float dot2(uint32_t a, uint32_t b, float acc) {
  const float2 fx = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a));
  const float2 fy = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&b));
  return fmaf(fx.y, fy.y, fmaf(fx.x, fy.x, acc));
}

// acc + the dot product of two 16-byte vectors of 8 bf16, in f32, in order
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
    acc = fmaf(fx.x, fy.x, acc);
    acc = fmaf(fx.y, fy.y, acc);
  }
  return acc;
}

struct NoBias {
  static constexpr bool kActive = false;
  __device__ __forceinline__ float operator()(int, int) const { return 0.f; }
};

// Attention of rows [q0, q0 + BQ) of one (batch*head) slice.
//   q: (Lq, D), k/v: (Lk, D), o: (Lq, D) bf16 row-major; lse: (Lq,) or null.
//   Key c is visible to row r iff c < kv_len and, when causal,
//   c <= r + offset (bottom-right alignment, offset = Lk - Lq).
//   A row that sees no key writes o = 0 and lse = 0.
template <int D, class Bias>
__device__ __forceinline__ void attention_rows(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
    int Lq, int Lk, int q0, int kv_len, float scale, bool causal, int offset,
    const Bias& bias, bf16 (*Ks)[D + 8], bf16 (*Vs)[D + 8]) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int KS = D / 16;  // k-steps of S = Q K^T over the head dim
  constexpr int ND = D / 8;   // n-blocks of O over the head dim
  constexpr int NB = BK / 8;  // n-blocks of S over one key tile
  constexpr int CH = D / 8;   // 16-byte chunks per row

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
  const bool in0 = r0 < Lq, in1 = r1 < Lq;

  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + t * 2;
    qa[ks][0] = in0 ? ld32(q + (size_t)r0 * D + c) : 0u;
    qa[ks][1] = in1 ? ld32(q + (size_t)r1 * D + c) : 0u;
    qa[ks][2] = in0 ? ld32(q + (size_t)r0 * D + c + 8) : 0u;
    qa[ks][3] = in1 ? ld32(q + (size_t)r1 * D + c + 8) : 0u;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = neg_inf(), m1 = neg_inf(), l0 = 0.f, l1 = 0.f;

  const int kvl = min(Lk, kv_len);
  int kend = kvl;
  if (causal) kend = min(kend, q0 + BQ + offset);
  const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;

  for (int kt = 0; kt < ntiles; ++kt) {
    const int kbase = kt * BK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < BK * CH; i += NTHREADS) {
      const int row = i / CH, ch = i % CH;
      const int key = kbase + row;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key < Lk) {
        kv = *reinterpret_cast<const uint4*>(k + (size_t)key * D + ch * 8);
        vv = *reinterpret_cast<const uint4*>(v + (size_t)key * D + ch * 8);
      }
      *reinterpret_cast<uint4*>(&Ks[row][ch * 8]) = kv;
      *reinterpret_cast<uint4*>(&Vs[row][ch * 8]) = vv;
    }
    __syncthreads();

    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const bf16* kr = &Ks[nb * 8 + g][ks * 16 + t * 2];
        mma16816(s[nb], qa[ks], ld32(kr), ld32(kr + 8));
      }
    }

    float mx0 = neg_inf(), mx1 = neg_inf();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = kbase + nb * 8 + t * 2 + j;
        const bool ok = c < kvl;
        const bool ok0 = ok && (!causal || c <= r0 + offset);
        const bool ok1 = ok && (!causal || c <= r1 + offset);
        float x0 = s[nb][j] * scale, x1 = s[nb][2 + j] * scale;
        if (Bias::kActive) {
          if (ok0) x0 += bias(r0, c);
          if (ok1) x1 += bias(r1, c);
        }
        s[nb][j] = ok0 ? x0 : neg_inf();
        s[nb][2 + j] = ok1 ? x1 : neg_inf();
        mx0 = fmaxf(mx0, s[nb][j]);
        mx1 = fmaxf(mx1, s[nb][2 + j]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));

    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with no visible key so far keeps max -inf: exponentiate
    // against 0 so every masked entry and the old state give exactly 0
    const float mu0 = mn0 == neg_inf() ? 0.f : mn0;
    const float mu1 = mn1 == neg_inf() ? 0.f : mn1;
    const float al0 = exp2f((m0 - mu0) * LOG2E);
    const float al1 = exp2f((m1 - mu1) * LOG2E);
    m0 = mn0;
    m1 = mn1;

    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[nb][j] = exp2f((s[nb][j] - mu0) * LOG2E);
        s[nb][2 + j] = exp2f((s[nb][2 + j] - mu1) * LOG2E);
        rs0 += s[nb][j];
        rs1 += s[nb][2 + j];
      }
    }
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;

#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // O += P V: the S accumulator layout of two adjacent n-blocks is the
    // A-fragment layout of one 16-key k-step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int key = kk * 16 + t * 2;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int col = n * 8 + g;
        const uint32_t b0 = pack_bf16(Vs[key][col], Vs[key + 1][col]);
        const uint32_t b1 = pack_bf16(Vs[key + 8][col], Vs[key + 9][col]);
        mma16816(acc[n], pa, b0, b1);
      }
    }
  }

  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + t * 2;
    if (in0)
      *reinterpret_cast<uint32_t*>(o + (size_t)r0 * D + col) =
          pack_f32(acc[n][0] * inv0, acc[n][1] * inv0);
    if (in1)
      *reinterpret_cast<uint32_t*>(o + (size_t)r1 * D + col) =
          pack_f32(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (lse != nullptr && t == 0) {
    if (in0) lse[r0] = l0 > 0.f ? m0 + logf(l0) : 0.f;
    if (in1) lse[r1] = l1 > 0.f ? m1 + logf(l1) : 0.f;
  }
}

}  // namespace ivlm

// Each library exports this next to its launcher so the Python wrapper can
// turn a non-zero launch status into a readable error.
#define IVLM_EXPORT_ERROR_STRING(prefix)                        \
  extern "C" const char* prefix##_error_string(int code) {      \
    return cudaGetErrorString(static_cast<cudaError_t>(code));  \
  }
