// Flash attention backward for Hopper (sm_90a): two kernels, dQ (which also
// forms D = rowsum(dO * O)) and dK/dV, bf16 in, bf16 out, f32 accumulation.
//
// Replaces the Pallas TPU kernels interactvlm_tpu/ops/flash_attention.py
// `_bwd_dq_kernel` and `_bwd_dkv_kernel` (wrapper `_flash_backward`), and
// the rowsum D that the wrapper took outside them. Both recompute the
// probabilities from the forward's per-row logsumexp,
//   P = exp(S * scale - lse), masked as the forward masks (key c is visible
//   to query r iff c < kv_len and, under causal, c <= r + Lk - Lq),
//   dP = dO V^T, dS = P * (dP - D) with D = rowsum(dO * O) in f32,
//   dV = P^T dO, dK = scale * dS^T Q, dQ = scale * dS K,
// so no (Lq, Lk) matrix ever reaches device memory. A row that sees no key
// has P = 0 and contributes nothing: its dQ is 0, never NaN. The dq kernel
// owns whole query rows, so it reads O and forms D itself, uses it for its
// own dS and writes it to a (B*H, Lq) f32 buffer that the dk/dv kernel,
// launched after it on the same stream, reads (at head dim 16 and at most
// 16 keys one pass computes all three gradients, and D stays in it).
//
// Head dim 128 (the LLaMA-13B shapes) takes the wgmma + TMA kernels of
// flash_bwd_sm90.cuh, head dim 16 (the SAM decoder's image->token
// attention and the fusion) those of flash_bwd_d16_sm90.cuh, which read and
// write the projections' views (ivlm_flash_bwd_d16_dq / _dkv below); each
// header says what bounds its kernels. 32 and 64 (no caller of the port's
// presets) take the mma.sync kernels below.
//
// Design of the mma.sync kernels. The TPU kernels pad D to 128 and the
// sequence to 128-row blocks and keep a whole (bh) slice of K/V (dq) or
// Q/dO (dkv) in VMEM. Here:
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
// - At Lk <= 64 one key tile is all there is, so one block per (bh) would
//   walk every query alone (4096 of them at Lq = 4096, 256 blocks on
//   132 SMs at B*H = 256). There the query walk is split over a third grid dimension
//   (ops/flash_attention.py:dkv_split): each split writes its partial dK
//   and dV in f32 to a workspace, and a second launch adds the splits in
//   order, so the sum stays deterministic. (Measured at the SAM shape: the
//   second launch is a few microseconds, so a last-block reduce inside the
//   kernel would gain little.) At Lk <= 16 one warp
//   would hold every key and do every product while three idled: there
//   all four warps take the 16 keys, each its own 16 queries of a tile,
//   and add their sums in warp order at the end.
// - bf16 mma.sync.m16n8k16 with f32 accumulation throughout; P and dS are
//   rounded to bf16 as the products' A operands. The ragged edges (Lk off
//   the tiles, rows past Lq, keys past kv_len) are masked in-kernel, never padded.
#include "attention_core.cuh"
#include "flash_bwd_d16_sm90.cuh"
#include "flash_bwd_sm90.cuh"

using namespace ivlm;

namespace {

// queries per inner chunk of the dk/dv kernel; at Lk <= kShortKeys all
// four warps take the tile's keys, each its own chunk of 16 queries
constexpr int kDkvChunk = 32;
constexpr int kShortKeys = 16;

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dO,
                        const bf16* __restrict__ o,
                        const float* __restrict__ lse,
                        float* __restrict__ dsum, bf16* __restrict__ dq,
                        const int* __restrict__ kv_lengths, int heads, int Lq,
                        int Lk, float scale, int causal) {
  constexpr int KS = D / 16;  // k-steps over the head dim
  constexpr int ND = D / 8;   // n-blocks of dQ over the head dim
  constexpr int CH = D / 8;   // 16-byte chunks per row
  constexpr int NB = BK / 8;  // n-blocks of S over one key tile
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
  o += qoff;
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
  // D = rowsum(dO * O) in f32: a quad's dO fragments hold its two rows
  // whole, so each thread multiplies them by O's elements at the same
  // places and the quad adds its parts
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + t * 2;
    if (in0) {
      d0 = dot2(da[ks][0], ld32(o + (size_t)r0 * D + c), d0);
      d0 = dot2(da[ks][2], ld32(o + (size_t)r0 * D + c + 8), d0);
    }
    if (in1) {
      d1 = dot2(da[ks][1], ld32(o + (size_t)r1 * D + c), d1);
      d1 = dot2(da[ks][3], ld32(o + (size_t)r1 * D + c + 8), d1);
    }
  }
  d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
  d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
  if (t == 0) {
    if (in0) dsum[r0] = d0;
    if (in1) dsum[r1] = d1;
  }

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

    // S = Q K^T and dP = dO V^T over this tile's keys
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      dp[nb][0] = dp[nb][1] = dp[nb][2] = dp[nb][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const bf16* kr = &Ks[nb * 8 + g][ks * 16 + t * 2];
        const bf16* vr = &Vs[nb * 8 + g][ks * 16 + t * 2];
        mma16816(s[nb], qa[ks], ld32(kr), ld32(kr + 8));
        mma16816(dp[nb], da[ks], ld32(vr), ld32(vr + 8));
      }
    }
    // dS = P * (dP - D), P recomputed from the logsumexp; into s
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = kbase + nb * 8 + t * 2 + j;
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
        const uint32_t b0 = pack_bf16(Ks[key][col], Ks[key + 1][col]);
        const uint32_t b1 = pack_bf16(Ks[key + 8][col], Ks[key + 9][col]);
        mma16816(acc[n], pa, b0, b1);
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
__host__ __device__ constexpr int dkv_smem_bytes() {
  return (2 * BK + 2 * BQ) * (D + 8) * (int)sizeof(bf16) +
         2 * BQ * (int)sizeof(float);
}

template <int D, bool kShort>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dO,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, float* __restrict__ part,
                         const int* __restrict__ kv_lengths, int heads, int Lq,
                         int Lk, float scale, int causal, int split_tiles) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;
  constexpr int ND = D / 8;
  constexpr int CH = D / 8;
  constexpr int QC = kShort ? 16 : kDkvChunk;
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

  // this thread's key rows kr, kr + 8
  const int kr = (kShort ? 0 : warp * 16) + g;
  const int j0 = k0 + kr, j1 = j0 + 8;
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  // the first query that can see key k0 is k0 - offset under causal; a
  // block whose keys all lie past kv_len sees none and writes zeros; split
  // z walks query tiles [z * split_tiles, (z + 1) * split_tiles)
  const int split = blockIdx.z;
  const int qstart =
      max(causal ? max(0, k0 - offset) / BQ : 0, split * split_tiles);
  const int nqt =
      k0 < kvl ? min((Lq + BQ - 1) / BQ, (split + 1) * split_tiles) : 0;
  const bool live = k0 + kr - g < kvl;  // the warp's first key is visible

  // a query tile's Q, dO, lse and D go global -> registers -> shared
  // memory: the next tile's loads are issued before this tile's products
  constexpr int LOADS = BQ * CH / NTHREADS;
  static_assert(BQ * CH % NTHREADS == 0 && BQ <= NTHREADS, "tile loads");
  uint4 qn[LOADS], dn[LOADS];
  float ln = 0.f, sn = 0.f;
  auto fetch = [&](int qbase) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int e = tid + i * NTHREADS, r = qbase + e / CH, ch = e % CH;
      qn[i] = dn[i] = make_uint4(0, 0, 0, 0);
      if (r < Lq) {
        qn[i] = *reinterpret_cast<const uint4*>(q + (size_t)r * D + ch * 8);
        dn[i] = *reinterpret_cast<const uint4*>(dO + (size_t)r * D + ch * 8);
      }
    }
    const int r = qbase + tid;
    ln = tid < BQ && r < Lq ? lse[r] : 0.f;
    sn = tid < BQ && r < Lq ? dsum[r] : 0.f;
  };
  if (qstart < nqt) fetch(qstart * BQ);

  for (int qt = qstart; qt < nqt; ++qt) {
    const int qbase = qt * BQ;
    __syncthreads();  // every warp is done with the previous tile
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int e = tid + i * NTHREADS, row = e / CH, ch = e % CH;
      *reinterpret_cast<uint4*>(&Qs[row][ch * 8]) = qn[i];
      *reinterpret_cast<uint4*>(&Ds[row][ch * 8]) = dn[i];
    }
    if (tid < BQ) {
      Ls[tid] = ln;
      Ss[tid] = sn;
    }
    __syncthreads();
    if (qt + 1 < nqt) fetch(qbase + BQ);
    if (!live) continue;

#pragma unroll
    for (int cc = 0; cc < (kShort ? 1 : BQ / QC); ++cc) {
      const int qc = (kShort ? warp : cc) * QC;
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

  if (kShort) {
    // the warps hold the same keys' sums over their own queries: warps 1-3
    // hand theirs to warp 0 through the shared memory the tiles used, and
    // it adds them in warp order
    static_assert(3 * 8 * ND * 32 * 4 <= dkv_smem_bytes<D>(), "reduction");
    float* red = reinterpret_cast<float*>(smem);
    __syncthreads();  // every warp is done with the tiles
    if (warp > 0) {
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = ((warp - 1) * ND + n) * 8 + e;
          red[i * 32 + lane] = dka[n][e];
          red[(i + 4) * 32 + lane] = dva[n][e];
        }
    }
    __syncthreads();
    if (warp > 0) return;
#pragma unroll
    for (int w = 0; w < 3; ++w)
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = (w * ND + n) * 8 + e;
          dka[n][e] += red[i * 32 + lane];
          dva[n][e] += red[(i + 4) * 32 + lane];
        }
  }
  if (part != nullptr) {
    // a split's partial sums, unscaled, to the (splits, 2, BH, Lk, D)
    // workspace that flash_bwd_dkv_reduce_kernel adds up
    const size_t plane = (size_t)gridDim.x * Lk * D;
    float* pk = part + 2 * split * plane + koff;
    float* pv = pk + plane;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = n * 8 + t * 2;
      if (j0 < Lk) {
        *reinterpret_cast<float2*>(pk + (size_t)j0 * D + col) =
            make_float2(dka[n][0], dka[n][1]);
        *reinterpret_cast<float2*>(pv + (size_t)j0 * D + col) =
            make_float2(dva[n][0], dva[n][1]);
      }
      if (j1 < Lk) {
        *reinterpret_cast<float2*>(pk + (size_t)j1 * D + col) =
            make_float2(dka[n][2], dka[n][3]);
        *reinterpret_cast<float2*>(pv + (size_t)j1 * D + col) =
            make_float2(dva[n][2], dva[n][3]);
      }
    }
    return;
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

// dK = scale * (sum of the splits' partials), dV = their sum, each sum in
// split order: n = BH * Lk * D elements, two a thread.
__global__ void flash_bwd_dkv_reduce_kernel(const float* __restrict__ part,
                                            bf16* __restrict__ dk,
                                            bf16* __restrict__ dv, int splits,
                                            size_t n, float scale) {
  const size_t i = 2 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  float2 sk = make_float2(0.f, 0.f), sv = make_float2(0.f, 0.f);
  for (int z = 0; z < splits; ++z) {
    const float2 a = *reinterpret_cast<const float2*>(part + 2 * z * n + i);
    const float2 b = *reinterpret_cast<const float2*>(part + (2 * z + 1) * n + i);
    sk.x += a.x;
    sk.y += a.y;
    sv.x += b.x;
    sv.y += b.y;
  }
  *reinterpret_cast<uint32_t*>(dk + i) = pack_f32(sk.x * scale, sk.y * scale);
  *reinterpret_cast<uint32_t*>(dv + i) = pack_f32(sv.x, sv.y);
}

}  // namespace

// q, dO, o: (BH, Lq, D); k, v: (BH, Lk, D) bf16 contiguous; lse: (BH, Lq)
// f32; writes dsum: (BH, Lq) f32 and dq: (BH, Lq, D) bf16; kv_lengths:
// (BH / heads,) int32 or null. D = 128 launches the wgmma kernel, 32 and
// 64 the mma.sync one (16: ivlm_flash_bwd_d16_dq). Returns the launch
// status (0 = launched).
extern "C" int ivlm_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dO, const void* o,
                                 const void* lse, void* dsum, void* dq,
                                 const void* kv_lengths, int bh, int heads,
                                 int lq, int lk, int d, float scale, int causal,
                                 void* stream) {
  if (bh <= 0 || heads <= 0 || lq <= 0 || lk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* gp = static_cast<const bf16*>(dO);
  const bf16* op = static_cast<const bf16*>(o);
  const float* lp = static_cast<const float*>(lse);
  float* sp = static_cast<float*>(dsum);
  bf16* out = static_cast<bf16*>(dq);
  const int* kl = static_cast<const int*>(kv_lengths);
  if (d == flash_bwd_sm90::kD)
    return static_cast<int>(flash_bwd_sm90::launch_dq(
        qp, kp, vp, gp, op, lp, sp, out, kl, bh, heads, lq, lk, scale, causal,
        st));
  const dim3 grid(bh, (lq + BQ - 1) / BQ);
#define IVLM_LAUNCH(DIM)                                                    \
  case DIM:                                                                 \
    flash_bwd_dq_kernel<DIM><<<grid, NTHREADS, 0, st>>>(                    \
        qp, kp, vp, gp, op, lp, sp, out, kl, heads, lq, lk, scale, causal); \
    break;
  switch (d) {
    IVLM_LAUNCH(32)
    IVLM_LAUNCH(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef IVLM_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// As ivlm_flash_bwd_dq, reading dsum and writing dk, dv: (BH, Lk, D) bf16.
// On the mma.sync route (D = 32, 64) `splits` > 1 splits the query walk into
// runs of `split_tiles` 64-query tiles, each writing its partial sums to
// `part`, (splits, 2, BH, Lk, D) f32, which a second launch adds up;
// D = 128 takes no split.
extern "C" int ivlm_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dO, const void* lse,
                                  const void* dsum, void* dk, void* dv,
                                  void* part, const void* kv_lengths, int bh,
                                  int heads, int lq, int lk, int d,
                                  float scale, int causal, int splits,
                                  int split_tiles, void* stream) {
  if (bh <= 0 || heads <= 0 || lq <= 0 || lk <= 0 || splits <= 0 ||
      split_tiles <= 0 || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* gp = static_cast<const bf16*>(dO);
  const float* lp = static_cast<const float*>(lse);
  const float* sp = static_cast<const float*>(dsum);
  bf16* kout = static_cast<bf16*>(dk);
  bf16* vout = static_cast<bf16*>(dv);
  float* pp = splits > 1 ? static_cast<float*>(part) : nullptr;
  const int* kl = static_cast<const int*>(kv_lengths);
  if (d == flash_bwd_sm90::kD) {
    if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(flash_bwd_sm90::launch_dkv(
        qp, kp, vp, gp, lp, sp, kout, vout, kl, bh, heads, lq, lk, scale,
        causal, st));
  }
  const dim3 grid(bh, (lk + BK - 1) / BK, splits);
#define IVLM_LAUNCH(DIM)                                                     \
  case DIM:                                                                  \
    static_assert(dkv_smem_bytes<DIM>() <= 48 * 1024, "dk/dv shared memory"); \
    if (lk <= kShortKeys)                                                    \
      flash_bwd_dkv_kernel<DIM, true>                                        \
          <<<grid, NTHREADS, dkv_smem_bytes<DIM>(), st>>>(                   \
              qp, kp, vp, gp, lp, sp, kout, vout, pp, kl, heads, lq, lk,     \
              scale, causal, split_tiles);                                   \
    else                                                                     \
      flash_bwd_dkv_kernel<DIM, false>                                       \
          <<<grid, NTHREADS, dkv_smem_bytes<DIM>(), st>>>(                   \
              qp, kp, vp, gp, lp, sp, kout, vout, pp, kl, heads, lq, lk,     \
              scale, causal, split_tiles);                                   \
    break;
  switch (d) {
    IVLM_LAUNCH(32)
    IVLM_LAUNCH(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef IVLM_LAUNCH
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t n = (size_t)bh * lk * d;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n / 2 + threads - 1) / threads);
  flash_bwd_dkv_reduce_kernel<<<blocks, threads, 0, st>>>(pp, kout, vout,
                                                           splits, n, scale);
  return static_cast<int>(cudaGetLastError());
}

// D = 16, the first launch (ops/flash_attention.py:flash_bwd_dq): q, k, v,
// o, dO (B, H, L, 16) bf16 views with element strides (batch, head, row)
// sq, sk, sv, so, sdo, multiples of 8, unit stride on the head dim,
// 16-byte aligned; lse (B*H, Lq) f32; dq (B, Lq, H, 16) bf16; kv_lengths
// (B,) int32 or null. With part: the one pass, writing the dK/dV partials
// to part (runs, B*H, 2, 16, 16) f32 (dsum null); else the dq kernel,
// writing D to dsum (B*H, Lq) f32. key_width, group, kv_resident,
// tiles_per_cta: ops/flash_attention.py:d16_bwd_plan. Returns the launch
// status.
extern "C" int ivlm_flash_bwd_d16_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* dsum, void* dq, void* part,
    const void* kv_lengths, long long sq0, long long sq1, long long sq2,
    long long sk0, long long sk1, long long sk2, long long sv0, long long sv1,
    long long sv2, long long so0, long long so1, long long so2,
    long long sdo0, long long sdo1, long long sdo2, int b, int h, int lq,
    int lk, float scale, int causal, int key_width, int group,
    int kv_resident, int tiles_per_cta, void* stream) {
  const long long sq[3] = {sq0, sq1, sq2}, sk[3] = {sk0, sk1, sk2},
                  sv[3] = {sv0, sv1, sv2}, so[3] = {so0, so1, so2},
                  sdo[3] = {sdo0, sdo1, sdo2};
  return static_cast<int>(flash_bwd_d16::launch_rows(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dO), sq, sk, sv, so, sdo,
      static_cast<const float*>(lse), static_cast<float*>(dsum),
      static_cast<bf16*>(dq), static_cast<float*>(part),
      static_cast<const int*>(kv_lengths), b, h, lq, lk, scale, causal,
      key_width, group, kv_resident, tiles_per_cta,
      static_cast<cudaStream_t>(stream)));
}

// D = 16, the second launch (ops/flash_attention.py:flash_bwd_dkv), after
// ivlm_flash_bwd_d16_dq on the same stream: with part (the fused route's
// `runs` partials) the ordered reduce into dk, dv; else the dk/dv kernel
// over q, k, v, dO (as above), lse and the dq kernel's dsum. dk, dv: (B, Lk, H, 16)
// bf16. Returns the launch status.
extern "C" int ivlm_flash_bwd_d16_dkv(
    const void* q, const void* k, const void* v, const void* dO,
    const void* lse, const void* dsum, const void* part, void* dk, void* dv,
    const void* kv_lengths, long long sq0, long long sq1, long long sq2,
    long long sk0, long long sk1, long long sk2, long long sv0, long long sv1,
    long long sv2, long long sdo0, long long sdo1, long long sdo2, int b,
    int h, int lq, int lk, float scale, int causal, int runs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* kout = static_cast<bf16*>(dk);
  bf16* vout = static_cast<bf16*>(dv);
  if (part != nullptr)
    return static_cast<int>(flash_bwd_d16::launch_reduce(
        static_cast<const float*>(part), kout, vout, runs, b, h, lk, scale,
        st));
  const long long sq[3] = {sq0, sq1, sq2}, sk[3] = {sk0, sk1, sk2},
                  sv[3] = {sv0, sv1, sv2}, sdo[3] = {sdo0, sdo1, sdo2};
  return static_cast<int>(flash_bwd_d16::launch_dkv(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dO), sq, sk, sv,
      sdo, static_cast<const float*>(lse), static_cast<const float*>(dsum),
      kout, vout, static_cast<const int*>(kv_lengths), b, h, lq, lk, scale,
      causal, st));
}

// The CTAs an SM holds of the D = 16 rows kernel (one pass or not; key
// width, heads a CTA, key tiles, K and V resident or not): what
// ops/flash_attention.py:d16_bwd_plan sizes its runs by; or minus the error
// code.
extern "C" int ivlm_flash_bwd_d16_blocks_per_sm(int fused, int key_width,
                                                int group, int nkt,
                                                int kv_resident) {
  int per_sm = 0;
  const cudaError_t err = flash_bwd_d16::blocks_per_sm(
      fused, key_width, group, nkt, kv_resident, &per_sm);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

IVLM_EXPORT_ERROR_STRING(ivlm_flash_attention_bwd)
