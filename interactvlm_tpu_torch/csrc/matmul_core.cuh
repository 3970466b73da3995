// Shared device code of the hand-written matmul kernels: cp.async copies
// into shared memory, ldmatrix fragment loads, the int8 and bf16 mma.sync
// products, one block tiling with its chunk loads, chunk products and
// epilogue walk (the tensor-core rate probe), the per-row int8 quantization
// (the row quantize and the one-launch int8 matmul) and the epilogue
// arithmetic (rescale, GELU) of every int8 and bf16 matmul kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ivlm {

using bf16 = __nv_bfloat16;

enum Act { kNone = 0, kGelu = 1, kGeluTanh = 2 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 bytes read: the 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 matrices of 16-bit elements (or 8 x 16 of bytes): lanes 8i to
// 8i + 7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a b on int8 operands with int32 accumulators (wrapping, no
// saturation)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b on bf16 operands with f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The tensor-core product of an operand type: the K elements one mma takes
// and its accumulator type.
template <typename T>
struct Mma;

template <>
struct Mma<int8_t> {
  using Acc = int;
  static constexpr int kK = 32;
  __device__ static __forceinline__ void run(int (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    mma_s8(d, a, b0, b1);
  }
};

template <>
struct Mma<bf16> {
  using Acc = float;
  static constexpr int kK = 16;
  __device__ static __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    mma_bf16(d, a, b0, b1);
  }
};

// A block's tiling of out = x (M, K) W (N, K)^T: a BM x BN output tile,
// WARPS_M x WARPS_N warps each owning an (MT 16) x (NT 8) accumulator tile,
// K in BK-wide chunks, STAGES chunks of both operands in shared memory.
// Rows in shared memory are padded by 16 bytes, so the eight row addresses
// of an ldmatrix hit distinct banks.
template <typename T_, int BM_, int BN_, int BK_, int WARPS_M_, int WARPS_N_,
          int STAGES_>
struct Tile {
  using T = T_;
  using Op = Mma<T>;
  using Acc = typename Op::Acc;
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int kThreads = WARPS_M * WARPS_N * 32;
  static constexpr int kLds = BK + 16 / (int)sizeof(T);  // elements a row
  static constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
  static constexpr int MT = WTM / 16, NT = WTN / 8;
  static constexpr int kSmem = STAGES * (BM + BN) * kLds * (int)sizeof(T);
  static_assert(MT >= 1 && WTM % 16 == 0 && NT % 2 == 0, "warp tile");
  static_assert(BK % Op::kK == 0, "depth");
};

// cp.async of rows [r0, r0 + ROWS) and elements [k0, k0 + BK) of a
// row-major (R, K) matrix into s; what lies past R or K is zero-filled
// (K a multiple of 16 bytes).
template <typename T, int ROWS, int BK, int LDS, int NTHREADS>
__device__ __forceinline__ void load_chunk(T (*s)[LDS], const T* __restrict__ g,
                                           int r0, int R, int k0, int K,
                                           int tid) {
  constexpr int V = 16 / (int)sizeof(T);  // elements a 16-byte piece
  constexpr int CH = BK / V;              // pieces a row
  constexpr int PER = ROWS * CH / NTHREADS;
  static_assert(PER >= 1 && PER * NTHREADS == ROWS * CH, "chunk");
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int t = tid + i * NTHREADS;
    const int r = t / CH, kp = (t % CH) * V;
    const int gr = r0 + r, gk = k0 + kp;
    const bool ok = gr < R && gk < K;
    cp_async16(&s[r][kp], ok ? g + (size_t)gr * K + gk : g, ok);
  }
}

// One BK-wide chunk's products into the warp's accumulators: A fragments
// from rows wm.. of xa, B fragments from rows wn.. of wb (W is (N, K), so
// a row of wb is a column of the product).
template <class TL>
__device__ __forceinline__ void mma_chunk(
    typename TL::Acc (&acc)[TL::MT][TL::NT][4],
    const typename TL::T (*xa)[TL::kLds], const typename TL::T (*wb)[TL::kLds],
    int wm, int wn, int lane) {
  constexpr int KK = TL::Op::kK, MT = TL::MT, NT = TL::NT;
#pragma unroll
  for (int ks = 0; ks < TL::BK / KK; ++ks) {
    uint32_t a[MT][4], b[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = wm + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldsm_x4(a[mt], &xa[r][ks * KK + (lane >> 4) * (KK / 2)]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      const int n = wn + nt * 8 + (lane & 7) + (lane >> 4) * 8;
      uint32_t r4[4];
      ldsm_x4(r4, &wb[n][ks * KK + ((lane >> 3) & 1) * (KK / 2)]);
      b[nt][0] = r4[0];
      b[nt][1] = r4[1];
      b[nt + 1][0] = r4[2];
      b[nt + 1][1] = r4[3];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        TL::Op::run(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
}

template <int MT, int NT, typename Acc>
__device__ __forceinline__ void zero_acc(Acc (&acc)[MT][NT][4]) {
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NT; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = Acc(0);
}

// Calls f(c, m, n, v0, v1) for each two neighbouring accumulator elements
// of the warp inside (M, N): element e of tile (mt, nt) sits at row
// g + 8 (e / 2), column 2 (lane % 4) + e % 2 of the 16 x 8 tile, so v0 and
// v1 sit at columns n and n + 1 of row m. c = col(n) is read once for the
// thread's rows of a column pair (the output stores may alias the column
// data as far as the compiler knows, so f could not hoist it). N % 8 == 0:
// a tile is all in or all out.
template <class TL, typename Acc, typename Col, typename F>
__device__ __forceinline__ void for_each_pair(const Acc (&acc)[TL::MT][TL::NT][4],
                                              int m0, int n0, int M, int N,
                                              Col&& col, F&& f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp / TL::WARPS_N) * TL::WTM;
  const int wn = (warp % TL::WARPS_N) * TL::WTN;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < TL::NT; ++nt) {
    const int n = n0 + wn + nt * 8 + tig * 2;
    if (n >= N) continue;
    const auto c = col(n);
#pragma unroll
    for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mt * 16 + g + h * 8;
        if (m < M) f(c, m, n, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
  }
}

// 16 bytes of x: 8 bf16 or 4 f32 values, element i of the vector in order.
template <typename TX>
struct XVec;

template <>
struct XVec<bf16> {
  static constexpr int kN = 8;
  __device__ static __forceinline__ float get(const uint4& u, int i) {
    const uint32_t w = (&u.x)[i >> 1];
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <>
struct XVec<float> {
  static constexpr int kN = 4;
  __device__ static __forceinline__ float get(const uint4& u, int i) {
    return __uint_as_float((&u.x)[i]);
  }
};

// The largest |x| of a 16-byte vector: exact in f32 (|x| and max are exact
// in x's own type, and widening bf16 to f32 is exact). The vector is taken
// by value: a reference into global memory would be read a word at a time.
template <typename TX>
__device__ __forceinline__ float vec_amax(const uint4 u, float amax) {
#pragma unroll
  for (int e = 0; e < XVec<TX>::kN; ++e)
    amax = fmaxf(amax, fabsf(XVec<TX>::get(u, e)));
  return amax;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The per-row scales from the row's absmax, by IEEE division:
// inv = 127 / max(amax, 1e-8), x_scale = max(amax, 1e-8) / 127.
__device__ __forceinline__ void row_scales(float amax, float& inv,
                                           float& x_scale) {
  const float a = fmaxf(amax, 1e-8f);
  inv = __fdiv_rn(127.0f, a);
  x_scale = __fdiv_rn(a, 127.0f);
}

// rint (half to even) of |v| < 2^22: v + 1.5 2^23 rounds to an integer in
// f32 (half to even, as __float2int_rn), which sits in the low bits. Two
// full-rate instructions where the conversion runs at a quarter of the rate.
__device__ __forceinline__ int rint_small(float v) {
  return __float_as_int(__fadd_rn(v, 12582912.0f)) - 0x4B400000;
}

__device__ __forceinline__ uint32_t quant4(float a, float b, float c, float d,
                                           float inv) {
  // rint (half to even), then clip: |x * inv| <= 127 up to one rounding, so
  // the clip only guards; never roundf, which rounds half away from zero
  const int qa = max(-127, min(127, rint_small(__fmul_rn(a, inv))));
  const int qb = max(-127, min(127, rint_small(__fmul_rn(b, inv))));
  const int qc = max(-127, min(127, rint_small(__fmul_rn(c, inv))));
  const int qd = max(-127, min(127, rint_small(__fmul_rn(d, inv))));
  return (uint32_t(qa) & 0xffu) | ((uint32_t(qb) & 0xffu) << 8) |
         ((uint32_t(qc) & 0xffu) << 16) | ((uint32_t(qd) & 0xffu) << 24);
}

// One 16-byte vector of x quantized: 8 int8 values (bf16 x) as a uint2, or
// 4 (f32 x) in .x.
template <typename TX>
__device__ __forceinline__ uint2 quant_vec(const uint4 u, float inv) {
  using G = XVec<TX>;
  uint2 q;
  q.x = quant4(G::get(u, 0), G::get(u, 1), G::get(u, 2), G::get(u, 3), inv);
  if constexpr (G::kN == 8) {
    q.y = quant4(G::get(u, 4), G::get(u, 5), G::get(u, 6), G::get(u, 7), inv);
  } else {
    q.y = 0u;
  }
  return q;
}

// The activation of an f32 epilogue value: exact (erf) GELU or tanh GELU.
__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == kGelu) {
    v = 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
  } else if (act == kGeluTanh) {
    const float inner = 0.79788456080286536f * (v + 0.044715f * v * v * v);
    v = 0.5f * v * (1.0f + tanhf(inner));
  }
  return v;
}

// The int8 epilogue of one accumulator in the TPU kernel's order:
// (acc * x_scale) * w_scale, + bias, then the activation, each step rounded
// on its own (no contraction into an fma).
__device__ __forceinline__ float rescale(int acc, float xs, float ws, float b,
                                         bool has_bias, int act) {
  float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
  if (has_bias) v = __fadd_rn(v, b);
  return apply_act(v, act);
}

}  // namespace ivlm

#ifndef IVLM_EXPORT_ERROR_STRING
// Each library exports this next to its launcher so the Python wrapper can
// turn a non-zero launch status into a readable error.
#define IVLM_EXPORT_ERROR_STRING(prefix)                        \
  extern "C" const char* prefix##_error_string(int code) {      \
    return cudaGetErrorString(static_cast<cudaError_t>(code));  \
  }
#endif
