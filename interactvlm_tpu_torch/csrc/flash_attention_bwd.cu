// Flash attention backward for Hopper (sm_90a): two kernels, dQ and dK/dV,
// bf16 in, bf16 out, f32 accumulation.
//
// Replaces the Pallas TPU kernels interactvlm_tpu/ops/flash_attention.py
// `_bwd_dq_kernel` and `_bwd_dkv_kernel` (wrapper `_flash_backward`). Both
// recompute the probabilities from the forward's per-row logsumexp,
//   P = exp(S * scale - lse), masked as the forward masks (key c is visible
//   to query r iff c < kv_len and, under causal, c <= r + Lk - Lq),
//   dP = dO V^T, dS = P * (dP - D) with D = rowsum(dO * O) (computed by the
//   wrapper), dV = P^T dO, dK = scale * dS^T Q, dQ = scale * dS K,
// so no (Lq, Lk) matrix ever reaches device memory. A row that sees no key
// has P = 0 and contributes nothing: its dQ is 0, never NaN.
//
// What bounds them on the H100: at the LLaMA-13B training shape (B*H = 320,
// L = 512, D = 128, causal) the backward does about 2.5x the forward's
// matrix work (five L x L x D products against two) over the same bytes plus
// dO, dQ, dK and dV, about 200 flops a byte: under the card's ~295 bf16
// flops/byte ridge, so the bytes bound it, though only barely. At the SAM
// decoder's image->token shape (Lk = 9, D = 16) it is the bytes by far.
//
// Design. The TPU kernels pad D to 128 and the sequence to 128-row blocks
// and keep a whole (bh) slice of K/V (dq) or Q/dO (dkv) in VMEM. Here:
// - dq: a block owns one (bh, 64-query tile) and 4 warps of 16 rows, as the
//   forward does. Q and dO stay in registers as mma.sync A fragments; K and
//   V come through shared memory 64 keys at a time, only the tiles that the
//   causal limit and kv_len leave visible; dQ accumulates in f32 registers.
// - dkv: a block owns one (bh, 64-key tile), a warp 16 keys. K and V stay in
//   shared memory; the block walks the query tiles from the first one the
//   causal mask lets see its keys, staging Q, dO, lse and D per tile, and
//   computes S^T = K Q^T and dP^T = V dO^T, so the probabilities land in
//   registers already in the A-fragment layout of dV += P^T dO and
//   dK += dS^T Q. dK and dV accumulate in f32 registers: no atomics.
// - bf16 mma.sync.m16n8k16 with f32 accumulation throughout; P and dS are
//   rounded to bf16 as the products' A operands. The ragged edges (Lk = 9,
//   rows past Lq, keys past kv_len) are masked in-kernel, never padded.
// - The dkv kernel's shared memory (K, V, Q and dO tiles) exceeds the 48 KB
//   static limit at D = 128, so it is dynamic and the launcher raises the
//   kernel's limit first.
// Kept simple: no wgmma, TMA or pipelining yet.
#include "attention_core.cuh"

using namespace ivlm;

namespace {

// keys (dq) or queries (dkv) per inner chunk: D = 128 halves the chunk so
// the f32 accumulators and the chunk's S / dP stay within the registers
template <int D>
struct Chunk {
  static constexpr int dq = D >= 128 ? 32 : BK;
  static constexpr int dkv = D >= 128 ? 16 : 32;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dO,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum, bf16* __restrict__ dq,
                        const int* __restrict__ kv_lengths, int heads, int Lq,
                        int Lk, float scale, int causal) {
  constexpr int KS = D / 16;  // k-steps over the head dim
  constexpr int ND = D / 8;   // n-blocks of dQ over the head dim
  constexpr int CH = D / 8;   // 16-byte chunks per row
  constexpr int KC = Chunk<D>::dq;
  constexpr int NB = KC / 8;  // n-blocks of S over one key chunk
  __shared__ __align__(16) bf16 Ks[BK][D + 8];
  __shared__ __align__(16) bf16 Vs[BK][D + 8];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kv_len = kv_lengths != nullptr ? kv_lengths[bh / heads] : Lk;
  const int offset = Lk - Lq;
  const size_t qoff = (size_t)bh * Lq * D;
  const size_t koff = (size_t)bh * Lk * D;
  q += qoff;
  dO += qoff;
  dq += qoff;
  k += koff;
  v += koff;
  lse += (size_t)bh * Lq;
  dsum += (size_t)bh * Lq;

  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
  const bool in0 = r0 < Lq, in1 = r1 < Lq;
  uint32_t qa[KS][4], da[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + t * 2;
    qa[ks][0] = in0 ? ld32(q + (size_t)r0 * D + c) : 0u;
    qa[ks][1] = in1 ? ld32(q + (size_t)r1 * D + c) : 0u;
    qa[ks][2] = in0 ? ld32(q + (size_t)r0 * D + c + 8) : 0u;
    qa[ks][3] = in1 ? ld32(q + (size_t)r1 * D + c + 8) : 0u;
    da[ks][0] = in0 ? ld32(dO + (size_t)r0 * D + c) : 0u;
    da[ks][1] = in1 ? ld32(dO + (size_t)r1 * D + c) : 0u;
    da[ks][2] = in0 ? ld32(dO + (size_t)r0 * D + c + 8) : 0u;
    da[ks][3] = in1 ? ld32(dO + (size_t)r1 * D + c + 8) : 0u;
  }
  const float l0 = in0 ? lse[r0] : 0.f, l1 = in1 ? lse[r1] : 0.f;
  const float d0 = in0 ? dsum[r0] : 0.f, d1 = in1 ? dsum[r1] : 0.f;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

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

#pragma unroll
    for (int cc = 0; cc < BK / KC; ++cc) {
      const int kc = cc * KC;
      // S = Q K^T and dP = dO V^T over this chunk's keys
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
        dp[nb][0] = dp[nb][1] = dp[nb][2] = dp[nb][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const bf16* kr = &Ks[kc + nb * 8 + g][ks * 16 + t * 2];
          const bf16* vr = &Vs[kc + nb * 8 + g][ks * 16 + t * 2];
          mma16816(s[nb], qa[ks], ld32(kr), ld32(kr + 8));
          mma16816(dp[nb], da[ks], ld32(vr), ld32(vr + 8));
        }
      }
      // dS = P * (dP - D), P recomputed from the logsumexp; into s
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = kbase + kc + nb * 8 + t * 2 + j;
          const bool ok = c < kvl;
          const bool ok0 = ok && (!causal || c <= r0 + offset);
          const bool ok1 = ok && (!causal || c <= r1 + offset);
          const float p0 = ok0 ? exp2f((s[nb][j] * scale - l0) * LOG2E) : 0.f;
          const float p1 =
              ok1 ? exp2f((s[nb][2 + j] * scale - l1) * LOG2E) : 0.f;
          s[nb][j] = p0 * (dp[nb][j] - d0);
          s[nb][2 + j] = p1 * (dp[nb][2 + j] - d1);
        }
      }
      // dQ += dS K: two adjacent n-blocks of dS are one A fragment
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const int key = kc + kk * 16 + t * 2;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const int col = n * 8 + g;
          const uint32_t b0 = pack_bf16(Ks[key][col], Ks[key + 1][col]);
          const uint32_t b1 = pack_bf16(Ks[key + 8][col], Ks[key + 9][col]);
          mma16816(acc[n], pa, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + t * 2;
    if (in0)
      *reinterpret_cast<uint32_t*>(dq + (size_t)r0 * D + col) =
          pack_f32(acc[n][0] * scale, acc[n][1] * scale);
    if (in1)
      *reinterpret_cast<uint32_t*>(dq + (size_t)r1 * D + col) =
          pack_f32(acc[n][2] * scale, acc[n][3] * scale);
  }
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * BK + 2 * BQ) * (D + 8) * (int)sizeof(bf16) +
         2 * BQ * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dO,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum, bf16* __restrict__ dk,
                         bf16* __restrict__ dv,
                         const int* __restrict__ kv_lengths, int heads, int Lq,
                         int Lk, float scale, int causal) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;
  constexpr int ND = D / 8;
  constexpr int CH = D / 8;
  constexpr int QC = Chunk<D>::dkv;
  constexpr int NB = QC / 8;  // n-blocks of S^T over one query chunk
  extern __shared__ __align__(16) unsigned char smem[];
  bf16(*Ks)[LD] = reinterpret_cast<bf16(*)[LD]>(smem);
  bf16(*Vs)[LD] = Ks + BK;
  bf16(*Qs)[LD] = Vs + BK;
  bf16(*Ds)[LD] = Qs + BQ;
  float* Ls = reinterpret_cast<float*>(Ds + BQ);
  float* Ss = Ls + BQ;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kv_len = kv_lengths != nullptr ? kv_lengths[bh / heads] : Lk;
  const int kvl = min(Lk, kv_len);
  const int offset = Lk - Lq;
  const size_t qoff = (size_t)bh * Lq * D;
  const size_t koff = (size_t)bh * Lk * D;
  q += qoff;
  dO += qoff;
  k += koff;
  v += koff;
  dk += koff;
  dv += koff;
  lse += (size_t)bh * Lq;
  dsum += (size_t)bh * Lq;

  for (int i = tid; i < BK * CH; i += NTHREADS) {
    const int row = i / CH, ch = i % CH;
    const int key = k0 + row;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (key < Lk) {
      kv = *reinterpret_cast<const uint4*>(k + (size_t)key * D + ch * 8);
      vv = *reinterpret_cast<const uint4*>(v + (size_t)key * D + ch * 8);
    }
    *reinterpret_cast<uint4*>(&Ks[row][ch * 8]) = kv;
    *reinterpret_cast<uint4*>(&Vs[row][ch * 8]) = vv;
  }

  const int kr = warp * 16 + g;  // this thread's key rows kr, kr + 8
  const int j0 = k0 + kr, j1 = j0 + 8;
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  // the first query that can see key k0 is k0 - offset under causal; a
  // block whose keys all lie past kv_len sees none and writes zeros
  const int qstart = causal ? max(0, k0 - offset) / BQ : 0;
  const int nqt = k0 < kvl ? (Lq + BQ - 1) / BQ : 0;
  const bool live = k0 + warp * 16 < kvl;  // the warp has a visible key

  for (int qt = qstart; qt < nqt; ++qt) {
    const int qbase = qt * BQ;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < BQ * CH; i += NTHREADS) {
      const int row = i / CH, ch = i % CH;
      const int r = qbase + row;
      uint4 qv = make_uint4(0, 0, 0, 0), dv4 = make_uint4(0, 0, 0, 0);
      if (r < Lq) {
        qv = *reinterpret_cast<const uint4*>(q + (size_t)r * D + ch * 8);
        dv4 = *reinterpret_cast<const uint4*>(dO + (size_t)r * D + ch * 8);
      }
      *reinterpret_cast<uint4*>(&Qs[row][ch * 8]) = qv;
      *reinterpret_cast<uint4*>(&Ds[row][ch * 8]) = dv4;
    }
    for (int i = tid; i < BQ; i += NTHREADS) {
      const int r = qbase + i;
      Ls[i] = r < Lq ? lse[r] : 0.f;
      Ss[i] = r < Lq ? dsum[r] : 0.f;
    }
    __syncthreads();
    if (!live) continue;

#pragma unroll
    for (int cc = 0; cc < BQ / QC; ++cc) {
      const int qc = cc * QC;
      // S^T = K Q^T and dP^T = V dO^T: rows are this warp's keys
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
        dp[nb][0] = dp[nb][1] = dp[nb][2] = dp[nb][3] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int c = ks * 16 + t * 2;
        uint32_t ka[4], va[4];
        ka[0] = ld32(&Ks[kr][c]);
        ka[1] = ld32(&Ks[kr + 8][c]);
        ka[2] = ld32(&Ks[kr][c + 8]);
        ka[3] = ld32(&Ks[kr + 8][c + 8]);
        va[0] = ld32(&Vs[kr][c]);
        va[1] = ld32(&Vs[kr + 8][c]);
        va[2] = ld32(&Vs[kr][c + 8]);
        va[3] = ld32(&Vs[kr + 8][c + 8]);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const bf16* qr = &Qs[qc + nb * 8 + g][c];
          const bf16* dr = &Ds[qc + nb * 8 + g][c];
          mma16816(s[nb], ka, ld32(qr), ld32(qr + 8));
          mma16816(dp[nb], va, ld32(dr), ld32(dr + 8));
        }
      }
      // P^T into s, dS^T = P^T * (dP^T - D) into dp
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = qc + nb * 8 + t * 2 + j;  // query within the tile
          const int r = qbase + col;
          const float li = Ls[col], di = Ss[col];
          const bool okq = r < Lq;
          const bool ok0 = okq && j0 < kvl && (!causal || j0 <= r + offset);
          const bool ok1 = okq && j1 < kvl && (!causal || j1 <= r + offset);
          const float p0 = ok0 ? exp2f((s[nb][j] * scale - li) * LOG2E) : 0.f;
          const float p1 =
              ok1 ? exp2f((s[nb][2 + j] * scale - li) * LOG2E) : 0.f;
          s[nb][j] = p0;
          s[nb][2 + j] = p1;
          dp[nb][j] = p0 * (dp[nb][j] - di);
          dp[nb][2 + j] = p1 * (dp[nb][2 + j] - di);
        }
      }
      // dV += P^T dO and dK += dS^T Q over this chunk's queries
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {
        uint32_t pa[4], sa[4];
        pa[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        sa[0] = pack_f32(dp[2 * kk][0], dp[2 * kk][1]);
        sa[1] = pack_f32(dp[2 * kk][2], dp[2 * kk][3]);
        sa[2] = pack_f32(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        sa[3] = pack_f32(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
        const int qq = qc + kk * 16 + t * 2;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const int col = n * 8 + g;
          mma16816(dva[n], pa, pack_bf16(Ds[qq][col], Ds[qq + 1][col]),
                   pack_bf16(Ds[qq + 8][col], Ds[qq + 9][col]));
          mma16816(dka[n], sa, pack_bf16(Qs[qq][col], Qs[qq + 1][col]),
                   pack_bf16(Qs[qq + 8][col], Qs[qq + 9][col]));
        }
      }
    }
  }

#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + t * 2;
    if (j0 < Lk) {
      *reinterpret_cast<uint32_t*>(dk + (size_t)j0 * D + col) =
          pack_f32(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + (size_t)j0 * D + col) =
          pack_f32(dva[n][0], dva[n][1]);
    }
    if (j1 < Lk) {
      *reinterpret_cast<uint32_t*>(dk + (size_t)j1 * D + col) =
          pack_f32(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + (size_t)j1 * D + col) =
          pack_f32(dva[n][2], dva[n][3]);
    }
  }
}

template <int D>
cudaError_t launch_dkv(dim3 grid, cudaStream_t st, const bf16* q,
                       const bf16* k, const bf16* v, const bf16* dO,
                       const float* lse, const float* dsum, bf16* dk,
                       bf16* dv, const int* kl, int heads, int lq, int lk,
                       float scale, int causal) {
  constexpr int smem = dkv_smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, smem, st>>>(
      q, k, v, dO, lse, dsum, dk, dv, kl, heads, lq, lk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, dO: (BH, Lq, D); k, v: (BH, Lk, D) bf16 contiguous; lse, dsum: (BH, Lq)
// f32; dq: (BH, Lq, D) bf16; kv_lengths: (BH / heads,) int32 or null.
// Returns the launch status (0 = launched).
extern "C" int ivlm_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dO, const void* lse,
                                 const void* dsum, void* dq,
                                 const void* kv_lengths, int bh, int heads,
                                 int lq, int lk, int d, float scale, int causal,
                                 void* stream) {
  if (bh <= 0 || heads <= 0 || lq <= 0 || lk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(bh, (lq + BQ - 1) / BQ);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* gp = static_cast<const bf16*>(dO);
  const float* lp = static_cast<const float*>(lse);
  const float* sp = static_cast<const float*>(dsum);
  bf16* op = static_cast<bf16*>(dq);
  const int* kl = static_cast<const int*>(kv_lengths);
#define IVLM_LAUNCH(DIM)                                                    \
  case DIM:                                                                 \
    flash_bwd_dq_kernel<DIM><<<grid, NTHREADS, 0, st>>>(                    \
        qp, kp, vp, gp, lp, sp, op, kl, heads, lq, lk, scale, causal);      \
    break;
  switch (d) {
    IVLM_LAUNCH(16)
    IVLM_LAUNCH(32)
    IVLM_LAUNCH(64)
    IVLM_LAUNCH(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef IVLM_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// As ivlm_flash_bwd_dq, writing dk, dv: (BH, Lk, D) bf16.
extern "C" int ivlm_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dO, const void* lse,
                                  const void* dsum, void* dk, void* dv,
                                  const void* kv_lengths, int bh, int heads,
                                  int lq, int lk, int d, float scale,
                                  int causal, void* stream) {
  if (bh <= 0 || heads <= 0 || lq <= 0 || lk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(bh, (lk + BK - 1) / BK);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* gp = static_cast<const bf16*>(dO);
  const float* lp = static_cast<const float*>(lse);
  const float* sp = static_cast<const float*>(dsum);
  bf16* kout = static_cast<bf16*>(dk);
  bf16* vout = static_cast<bf16*>(dv);
  const int* kl = static_cast<const int*>(kv_lengths);
  cudaError_t e;
#define IVLM_LAUNCH(DIM)                                                     \
  case DIM:                                                                  \
    e = launch_dkv<DIM>(grid, st, qp, kp, vp, gp, lp, sp, kout, vout, kl,    \
                        heads, lq, lk, scale, causal);                       \
    break;
  switch (d) {
    IVLM_LAUNCH(16)
    IVLM_LAUNCH(32)
    IVLM_LAUNCH(64)
    IVLM_LAUNCH(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef IVLM_LAUNCH
  return static_cast<int>(e);
}

IVLM_EXPORT_ERROR_STRING(ivlm_flash_attention_bwd)
