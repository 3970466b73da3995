// Flash attention forward for head dim 16 on Hopper's own machinery
// (sm_90a): wgmma products fed by TMA. Launched by ivlm_flash_fwd_d16
// (flash_attention.cu); head dim 128 takes flash_fwd_sm90.cuh, 32 and 64
// the mma.sync core of attention_core.cuh.
//
// Replaces, at D = 16, the Pallas TPU kernel
// interactvlm_tpu/ops/flash_attention.py `_flash_kernel` (wrapper
// `_flash_forward`): online-softmax attention over (B, H, L, 16) bf16,
// bottom-right-aligned causal masking (offset Lk - Lq), per-batch-row kv
// lengths, and the f32 per-row logsumexp (B*H, Lq) the backward kernels
// read. A row that sees no key writes o = 0 and lse = 0.
//
// Where it runs: the SAM decoder's image -> token attention (B*V = 32
// images, 8 heads, Lq = 4096 image tokens, Lk = 9 prompt tokens) in every
// serving batch, training step, validate batch and demo image, and the
// fusion's image -> LLaVA attention (Lk up to 512).
//
// What bounds it on the H100: at Lk = 9 the bytes (q and o, 33.5 MB each
// at 32 x 8 x 4096 rows, ~0.021 ms at 3.35 TB/s); at Lk = 512 the
// exponentials (5.4e8 on the special-function units, 16 a clock an SM:
// ~0.128 ms), the tensor operations a quarter of that. The mma.sync core
// this replaces ran 64-key tiles (55 of 64 keys masked at Lk = 9), 16 384
// CTAs of 64 rows that each staged K and V with plain loads, no load
// under a product, 4-byte loads of q and stores of o, and took contiguous
// copies of q, k and v and gave o back to be transposed. Here:
// - a key tile is N = 16 ceil(Lk / (16 t)) keys wide for the fewest tiles
//   t of at most 128 keys (ops/flash_attention.py:d16_key_tiles): 16 at
//   Lk = 9, so a row runs 16 exponentials, not 64. Wider tiles (to 256)
//   held S in 128 registers a thread, where ptxas spilled and serialized
//   the products, and fitted 3 CTAs an SM against 128-key tiles' 4.
//   S = Q K^T is one wgmma m64nNk16 (D = 16 is one k-step), both operands
//   from shared memory, K-major in the 32-byte swizzle (a row of 16 bf16
//   is 32 bytes); O += P V is N / 16 wgmma m64n16k16 with P from
//   registers (the S accumulator of two neighbouring 8-key blocks is the A
//   fragment of a 16-key step) and V's tile an MN-major B. At N <= 64 both
//   64-row halves' products issue together, one wait for the pair;
// - a CTA is one warpgroup that walks a run of 128-row query tiles of a
//   group of G heads of one batch row (2 where H is even and their K and
//   V fit in 32 KB, else 1): K and V of those heads arrive by TMA once and
//   stay in shared memory for the run (past 227 KB of keys they stream
//   through a ring, reloaded for each query tile, with G = 1), and the
//   query tiles of the G heads arrive by TMA, one box a tile, through a
//   ring of 2 (G > 1) or 4, so later tiles load while this one computes;
//   8 CTAs an SM at Lk = 9 (the register budget's limit: a tighter one
//   spills), so one's softmax runs while another's products or loads do.
//   The launch walks the tiles in runs sized to 4 waves of the card's
//   occupancy;
// - the softmax: the row maximum of the raw logits, then one FFMA a logit
//   (scale log2 e folded in) and ex2 on the special-function unit; mask
//   compares only on a tile that holds a kv-length or causal edge; row
//   sums kept per thread and added across the quad once, at the end;
// - q, k and v are read where the projections leave them: 4-D tensor maps
//   (head-dim column, row, head, batch) over the views' strides, rows past
//   Lq or Lk of a head zero-filled by TMA; o is written as (B, Lq, H, 16),
//   so the caller's transpose back to tokens costs no copy. Each warp
//   storing its rows' 32 bytes of one head as it finished them left the
//   writes well below the card's rate (the same bytes written contiguous
//   a head went much faster); so each head's o is staged, normalised, in
//   its own query slot once its products are done, and the CTA copies the
//   tile out at its end in 16-byte stores a thread over G x 32 bytes of
//   each row; the logsumexp is staged beside it and leaves in 16-byte
//   stores of four rows.
#pragma once

#include <algorithm>
#include <type_traits>

#include "attention_core.cuh"
#include "d16_sm90.cuh"
#include "sm90_core.cuh"

namespace ivlm {
namespace flash_d16 {

using namespace ivlm::sm90;
using namespace ivlm::d16_sm90;

constexpr int kD = 16;
constexpr int kRowBytes = 32;   // one row of q, k or v in shared memory
constexpr int kBQ = 128;        // query rows a tile: two halves of 64
constexpr int kQTileBytes = kBQ * kRowBytes;  // a head's query tile
constexpr int kMaxKeyWidth = 128;  // the widest key tile (wgmma's N)
constexpr int kMaxGroup = 8;    // heads a CTA
constexpr int kAutoGroup = 2;   // heads a CTA the launch picks, at most
constexpr int kRingSlots = 4;   // key tiles in flight where K, V stream
constexpr int kThreads = 128;   // one warpgroup
constexpr int kMaxSmem = 232448;
constexpr int kGroupKVBytes = 32 * 1024;  // K and V of a head group, at most
constexpr int kWaves = 4;  // CTAs a launch, as a multiple of the card's fill

// the register budget a key width allows: CTAs an SM that __launch_bounds__
// asks ptxas to fit (65536 registers / 128 threads / this)
template <int N>
constexpr int min_blocks() {
  return N <= 32 ? 8 : N <= 64 ? 6 : 4;
}

struct Params {
  const int* kv_lengths;  // (B,) or null
  bf16* o;                // (B, Lq, H, 16)
  float* lse;             // (B * H, Lq)
  int heads, Lq, Lk;
  int group;          // G, heads a CTA
  int nqt;            // query tiles of a (b, h)
  int tiles_per_cta;  // query tiles a CTA walks
  int qstages;        // query tiles in flight a CTA
  int nkt;            // key tiles of Lk
  int kv_slots;       // key tiles shared memory holds; resident iff >= nkt
  float scale;        // for the logsumexp, natural-log units
  float sc2;          // scale * log2 e
  int causal;
};

// The online softmax of one half (64 rows from `hrow`) against one key
// tile, on S's accumulator s: P into pa as the A fragments of O += P V, o
// rescaled. m, l: the running maximum (raw logits) and this thread's
// partial row sum, of rows r0 and r1.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2],
                                             uint32_t (&pa)[N / 16][4],
                                             int kbase, int hrow, int kvl,
                                             int offset, const Params& p,
                                             int warp, int g, int tig,
                                             float (&o)[8], float (&m)[2],
                                             float (&l)[2]) {
  // s[4 j + e]: row r0 (e < 2) or r1, key kbase + 8 j + 2 tig + e % 2
  const bool edge = kbase + N > kvl ||
                    (p.causal && kbase + N - 1 > hrow + offset);
  if (edge) {
    const int r0 = hrow + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = kbase + 8 * j + 2 * tig + (e & 1);
        const int r = r0 + (e & 2) * 4;
        if (c >= kvl || (p.causal && c > r + offset)) s[4 * j + e] = neg_inf();
      }
    }
  }
  // two chains a row, so the maxima do not wait on each other
  float mx[4] = {neg_inf(), neg_inf(), neg_inf(), neg_inf()};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    mx[j & 1] = fmaxf(mx[j & 1], fmaxf(s[4 * j + 0], s[4 * j + 1]));
    mx[2 + (j & 1)] = fmaxf(mx[2 + (j & 1)], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float mx0 = fmaxf(mx[0], mx[1]), mx1 = fmaxf(mx[2], mx[3]);
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
  // a row with no visible key so far keeps max -inf: exponentiate against
  // 0 so every masked logit and the old state give exactly 0
  const float mu0 = mn0 == neg_inf() ? 0.f : mn0;
  const float mu1 = mn1 == neg_inf() ? 0.f : mn1;
  const float al0 = exp2_ftz((m[0] - mu0) * p.sc2);
  const float al1 = exp2_ftz((m[1] - mu1) * p.sc2);
  m[0] = mn0;
  m[1] = mn1;
  const float nb0 = -mu0 * p.sc2, nb1 = -mu1 * p.sc2;

  float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float& x = s[8 * kk + i];
      x = exp2_ftz(fmaf(x, p.sc2, (i & 2) ? nb1 : nb0));
      sum[((i & 2) >> 1) * 2 + (kk & 1)] += x;
    }
    pa[kk][0] = pack_f32(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_f32(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_f32(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_f32(s[8 * kk + 6], s[8 * kk + 7]);
  }
  l[0] = l[0] * al0 + (sum[0] + sum[1]);
  l[1] = l[1] * al1 + (sum[2] + sum[3]);
  o[0] *= al0;
  o[1] *= al0;
  o[2] *= al1;
  o[3] *= al1;
  o[4] *= al0;
  o[5] *= al0;
  o[6] *= al1;
  o[7] *= al1;
}

// O += P V, issued (no fence, commit or wait): a k16 step each 16 keys; V's
// rows are keys (K), its 32 bytes the head dim (N)
template <int N>
__device__ __forceinline__ void pv(float (&o)[8],
                                   const uint32_t (&pa)[N / 16][4],
                                   uint32_t va) {
  const uint64_t dv = desc_sw32(va, N * kRowBytes, 256);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_bf16_rs_n16_tb(o, pa[kk], desc_at(dv, kk * 16 * kRowBytes), 1);
}

// One half against one key tile: S, the softmax, O += P V.
template <int N>
__device__ __forceinline__ void half_step(uint32_t qa, uint32_t ka,
                                          uint32_t va, int kbase, int hrow,
                                          int kvl, int offset,
                                          const Params& p, int warp, int g,
                                          int tig, float (&o)[8],
                                          float (&m)[2], float (&l)[2]) {
  float s[N / 2];
  uint32_t pa[N / 16][4];
  wgmma_fence();
  s_set(s, desc_sw32(qa, 16, 256), desc_sw32(ka, 16, 256));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  softmax_tile<N>(s, pa, kbase, hrow, kvl, offset, p, warp, g, tig, o, m, l);
  wgmma_fence();
  pv<N>(o, pa, va);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// Both halves against one key tile, their products issued together (one
// wait for both S, one for both P V): at narrow key tiles the chain of
// waits, not the work, sets a tile's time. A half the causal mask hides
// from the whole tile runs too: its logits are all masked, so its state
// does not move.
template <int N>
__device__ __forceinline__ void pair_step(uint32_t qa, uint32_t ka,
                                          uint32_t va, int kbase, int q0,
                                          int kvl, int offset,
                                          const Params& p, int warp, int g,
                                          int tig, float (&o)[2][8],
                                          float (&m)[2][2], float (&l)[2][2]) {
  float s0[N / 2], s1[N / 2];
  uint32_t pa0[N / 16][4], pa1[N / 16][4];
  const uint64_t dk = desc_sw32(ka, 16, 256);
  wgmma_fence();
  s_set(s0, desc_sw32(qa, 16, 256), dk);
  s_set(s1, desc_sw32(qa + 64 * kRowBytes, 16, 256), dk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s0);
  fence_regs(s1);
  softmax_tile<N>(s0, pa0, kbase, q0, kvl, offset, p, warp, g, tig, o[0],
                  m[0], l[0]);
  softmax_tile<N>(s1, pa1, kbase, q0 + 64, kvl, offset, p, warp, g, tig,
                  o[1], m[1], l[1]);
  wgmma_fence();
  pv<N>(o[0], pa0, va);
  pv<N>(o[1], pa1, va);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o[0]);
  fence_regs(o[1]);
}

// One half (the tile's rows trow .. trow + 63) of head slot gi done: o,
// normalised, into the staging tile at `stage` (the head's query slot,
// whose products are done), tile row r at r xor (gi % 4), so that the
// CTA's row-major copy out reads four heads' rows from distinct banks; the
// logsumexp of each row into `lse_stage` (the head's 128 rows).
__device__ __forceinline__ void finish_half(const float (&o)[8],
                                            const float (&m)[2],
                                            const float (&l)[2], int trow,
                                            int gi, unsigned char* stage,
                                            float* lse_stage, const Params& p,
                                            int warp, int g, int tig) {
  float l0 = l[0], l1 = l[1];
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  // o[4 j + e]: row r0 (e < 2) or r1, columns 8 j + 2 tig + e % 2
  const int r0 = trow + warp * 16 + g, r1 = r0 + 8;
  unsigned char* s0 = stage + (r0 ^ (gi & 3)) * kRowBytes + 4 * tig;
  unsigned char* s1 = stage + (r1 ^ (gi & 3)) * kRowBytes + 4 * tig;
  *reinterpret_cast<uint32_t*>(s0) = pack_f32(o[0] * inv0, o[1] * inv0);
  *reinterpret_cast<uint32_t*>(s1) = pack_f32(o[2] * inv1, o[3] * inv1);
  *reinterpret_cast<uint32_t*>(s0 + 16) = pack_f32(o[4] * inv0, o[5] * inv0);
  *reinterpret_cast<uint32_t*>(s1 + 16) = pack_f32(o[6] * inv1, o[7] * inv1);
  if (tig == 0) {
    lse_stage[r0] = l0 > 0.f ? m[0] * p.scale + logf(l0) : 0.f;
    lse_stage[r1] = l1 > 0.f ? m[1] * p.scale + logf(l1) : 0.f;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, min_blocks<N>())
    flash_fwd_d16_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int G = p.group;
  const int q_stage = G * kQTileBytes;    // a ring slot: G heads' tiles
  const int kv_stage = G * N * kRowBytes; // a key tile of G heads
  unsigned char* qs = smem;
  unsigned char* ks = qs + p.qstages * q_stage;
  unsigned char* vs = ks + p.kv_slots * kv_stage;
  float* lse_stage = reinterpret_cast<float*>(vs + p.kv_slots * kv_stage);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(lse_stage + G * kBQ);
  uint64_t* kv_full = q_full + p.qstages;

  const int groups = p.heads / G;
  const int b = blockIdx.y / groups, h0 = (blockIdx.y - b * groups) * G;
  const int t0 = blockIdx.x * p.tiles_per_cta;
  const int nt = min(p.tiles_per_cta, p.nqt - t0);
  const int offset = p.Lk - p.Lq;
  int kvl = p.Lk;
  if (p.kv_lengths != nullptr) kvl = min(kvl, p.kv_lengths[b]);
  kvl = max(kvl, 0);
  const bool resident = p.nkt <= p.kv_slots;
  // key tiles query tile qt needs: those below kvl and, when causal, below
  // its last row's limit
  auto tiles_for = [&](int qt) {
    int kend = kvl;
    if (p.causal) kend = min(kend, qt * kBQ + kBQ + offset);
    return kend > 0 ? (kend + N - 1) / N : 0;
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    prefetch_tmap(&tq);
    prefetch_tmap(&tk);
    prefetch_tmap(&tv);
    for (int s = 0; s < p.qstages; ++s) mbar_init(&q_full[s], 1);
    for (int s = 0; s < p.kv_slots; ++s) mbar_init(&kv_full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();

  // thread 0 issues every load: one box of G heads a key tile of K, of V,
  // and a query tile
  const CUtensorMap* mq = &tq;
  const CUtensorMap* mk = &tk;
  const CUtensorMap* mv = &tv;
  auto load_kv = [&](int slot, int kt) {
    mbar_arrive_expect_tx(&kv_full[slot], 2 * kv_stage);
    tma_load_4d(ks + slot * kv_stage, mk, &kv_full[slot], 0, kt * N, h0, b);
    tma_load_4d(vs + slot * kv_stage, mv, &kv_full[slot], 0, kt * N, h0, b);
  };
  auto load_q = [&](int j) {
    const int slot = j % p.qstages;
    mbar_arrive_expect_tx(&q_full[slot], q_stage);
    tma_load_4d(qs + slot * q_stage, mq, &q_full[slot], 0, (t0 + j) * kBQ,
                h0, b);
  };
  // where K and V stream (G = 1): thread 0's cursor over the (query tile,
  // key tile) pairs the CTA consumes, one ring slot each in order
  int cj = 0, ckt = 0, cn = 0;
  auto cursor_next = [&]() {  // to the next pair; cj == nt past the last
    ++ckt;
    while (ckt >= cn && cj < nt) {
      ++cj;
      ckt = 0;
      cn = cj < nt ? tiles_for(t0 + cj) : 0;
    }
  };
  if (tid == 0) {
    if (resident) {
      // the last query tile needs the most keys
      const int n = tiles_for(t0 + nt - 1);
      for (int kt = 0; kt < n; ++kt) load_kv(kt, kt);
    } else {
      cn = tiles_for(t0);
      ckt = -1;
      cursor_next();
      for (int e = 0; e < p.kv_slots && cj < nt; ++e) {
        load_kv(e, ckt);
        cursor_next();
      }
    }
    for (int j = 0; j < nt && j < p.qstages; ++j) load_q(j);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  int e = 0;  // K/V ring pairs consumed (streaming)
  for (int j = 0; j < nt; ++j) {
    const int q0 = (t0 + j) * kBQ;
    const int slot = j % p.qstages;
    const int nk = tiles_for(t0 + j);
    unsigned char* qtile = qs + slot * q_stage;
    mbar_wait(&q_full[slot], (j / p.qstages) & 1);
    for (int gi = 0; gi < G; ++gi) {
      float o[2][8], m[2][2], l[2][2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int i = 0; i < 8; ++i) o[hf][i] = 0.f;
        m[hf][0] = m[hf][1] = neg_inf();
        l[hf][0] = l[hf][1] = 0.f;
      }
      const uint32_t qa = smem_addr(qtile + gi * kQTileBytes);
      for (int kt = 0; kt < nk; ++kt) {
        const int ks_slot = resident ? kt : e % p.kv_slots;
        mbar_wait(&kv_full[ks_slot], resident ? 0 : (e / p.kv_slots) & 1);
        const uint32_t ka =
            smem_addr(ks + ks_slot * kv_stage + gi * N * kRowBytes);
        const uint32_t va =
            smem_addr(vs + ks_slot * kv_stage + gi * N * kRowBytes);
        if constexpr (N <= 64) {
          pair_step<N>(qa, ka, va, kt * N, q0, kvl, offset, p, warp, g, tig,
                       o, m, l);
        } else {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int hrow = q0 + 64 * hf;
            // under the causal mask the half sees keys below hrow + 64 +
            // offset
            if (!p.causal || kt * N < hrow + 64 + offset)
              half_step<N>(qa + hf * 64 * kRowBytes, ka, va, kt * N, hrow,
                           kvl, offset, p, warp, g, tig, o[hf], m[hf], l[hf]);
          }
        }
        if (!resident) {
          __syncthreads();  // every warp's products on the slot are done
          if (tid == 0 && cj < nt) {
            load_kv(ks_slot, ckt);
            cursor_next();
          }
          ++e;
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        finish_half(o[hf], m[hf], l[hf], 64 * hf, gi,
                    qtile + gi * kQTileBytes, lse_stage + gi * kBQ, p, warp,
                    g, tig);
    }
    __syncthreads();  // the tile's o and logsumexp are staged
    // the tile out in 16-byte stores a thread: o row by row, G heads' 32
    // bytes each; the logsumexp four rows a store where they are aligned
    // and inside Lq
    const int rows = min(kBQ, p.Lq - q0);
    for (int k = tid; k < rows * 2 * G; k += kThreads) {
      const int row = k / (2 * G), hc = k - row * 2 * G;
      const int gi = hc >> 1, c = hc & 1;
      const uint4 val = *reinterpret_cast<const uint4*>(
          qtile + gi * kQTileBytes + (row ^ (gi & 3)) * kRowBytes + 16 * c);
      *reinterpret_cast<uint4*>(
          p.o + (((size_t)b * p.Lq + q0 + row) * p.heads + h0 + gi) * kD +
          8 * c) = val;
    }
    for (int k = tid; k < G * kBQ / 4; k += kThreads) {
      const int gi = k / (kBQ / 4), r = 4 * (k - gi * (kBQ / 4));
      if (r >= rows) continue;
      const float* src = lse_stage + gi * kBQ + r;
      float* dst = p.lse + (size_t)(b * p.heads + h0 + gi) * p.Lq + q0 + r;
      if (r + 3 < rows && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        *reinterpret_cast<float4*>(dst) =
            *reinterpret_cast<const float4*>(src);
      } else {
        for (int i = 0; i < 4 && r + i < rows; ++i) dst[i] = src[i];
      }
    }
    // the staging reads come before the next TMA write of the slot
    fence_proxy_async();
    __syncthreads();
    if (tid == 0 && j + p.qstages < nt) load_q(j + p.qstages);
  }
}

// The kernel for key width N set up to launch G heads a CTA with `nkt` key
// tiles: its shared memory (every key tile resident where they fit, else a
// ring), the query ring's depth and the CTAs an SM holds. The attributes
// and the occupancy are set and read once for each shared-memory size and
// device, not at every launch.
template <int N>
inline cudaError_t prepare(int G, int nkt, int* kv_slots, int* qstages,
                           int* smem, int* per_sm) {
  const auto kernel = flash_fwd_d16_kernel<N>;
  *qstages = G > 1 ? 2 : 4;
  const int fixed =
      1024 + *qstages * (G * kQTileBytes + 8) + G * kBQ * (int)sizeof(float);
  const int per_slot = 2 * G * N * kRowBytes + 8;
  *kv_slots = fixed + nkt * per_slot <= kMaxSmem ? nkt : kRingSlots;
  *smem = fixed + *kv_slots * per_slot;
  static int last_smem = -1, last_dev = -1, last_per_sm = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (*smem == last_smem && dev == last_dev) {
    *per_sm = last_per_sm;
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                      kThreads, *smem);
  if (err != cudaSuccess) return err;
  last_smem = *smem;
  last_dev = dev;
  last_per_sm = *per_sm;
  return cudaSuccess;
}

// Heads a CTA: the most of kAutoGroup .. 1 (powers of 2) that divides H
// and whose K and V (every key tile resident) fit in kGroupKVBytes. Wider
// groups write longer pieces of each o row, but their query rings cut the
// CTAs an SM (5 at 4 heads, 2 at 8), and at the SAM decoder's shape the
// CTAs an SM set the pace once o leaves through the staged tile
// (chip_smoke.py's by_heads_per_cta times each group on the card).
inline int auto_group(int H, int nkt, int key_width) {
  for (int G = kAutoGroup; G > 1; G /= 2)
    if (H % G == 0 && 2 * G * nkt * key_width * kRowBytes <= kGroupKVBytes)
      return G;
  return 1;
}

template <int N>
inline cudaError_t launch_width(const CUtensorMap& tq, const CUtensorMap& tk,
                                const CUtensorMap& tv, Params prm, int B,
                                int tiles_per_cta, cudaStream_t st) {
  int smem = 0, per_sm = 0;
  cudaError_t err = prepare<N>(prm.group, prm.nkt, &prm.kv_slots,
                               &prm.qstages, &smem, &per_sm);
  if (err != cudaSuccess) return err;
  if (prm.group > 1 && prm.kv_slots < prm.nkt) return cudaErrorInvalidValue;
  const int units = B * (prm.heads / prm.group);  // head groups
  if (tiles_per_cta <= 0) {
    // kWaves times as many CTAs as the card holds at once, each a run of
    // one head group's query tiles
    const long long cap =
        (long long)(per_sm > 0 ? per_sm : 1) * sm_count() * kWaves;
    const int runs = (int)std::min<long long>(
        prm.nqt, std::max<long long>(1, (cap + units - 1) / units));
    tiles_per_cta = (prm.nqt + runs - 1) / runs;
  }
  prm.tiles_per_cta = tiles_per_cta;
  const dim3 grid((prm.nqt + tiles_per_cta - 1) / tiles_per_cta, units);
  flash_fwd_d16_kernel<N><<<grid, kThreads, smem, st>>>(tq, tk, tv, prm);
  return cudaGetLastError();
}

// Calls f(std::integral_constant<int, N>{}) for key width N.
template <class F>
inline cudaError_t by_width(int key_width, F f) {
  switch (key_width) {
#define IVLM_D16_WIDTH(NN) \
  case NN:                 \
    return f(std::integral_constant<int, NN>{});
    IVLM_D16_WIDTH(16)
    IVLM_D16_WIDTH(32)
    IVLM_D16_WIDTH(48)
    IVLM_D16_WIDTH(64)
    IVLM_D16_WIDTH(80)
    IVLM_D16_WIDTH(96)
    IVLM_D16_WIDTH(112)
    IVLM_D16_WIDTH(128)
#undef IVLM_D16_WIDTH
    default:
      return cudaErrorInvalidValue;
  }
}

// The CTAs an SM holds at key width `key_width`, Lk keys and G heads a CTA
// (0: the launch's own choice), into *per_sm.
inline cudaError_t blocks_per_sm(int key_width, int lk, int H, int G,
                                 int* per_sm) {
  if (key_width < 16 || lk <= 0 || H <= 0) return cudaErrorInvalidValue;
  const int nkt = (lk + key_width - 1) / key_width;
  if (G <= 0) G = auto_group(H, nkt, key_width);
  return by_width(key_width, [&](auto n) {
    int slots = 0, stages = 0, smem = 0;
    return prepare<decltype(n)::value>(G, nkt, &slots, &stages, &smem,
                                       per_sm);
  });
}

// q, k, v: (B, H, L, 16) bf16 views, unit stride on the head dim, element
// strides s[0] (batch), s[1] (head), s[2] (row) that are multiples of 8,
// 16-byte aligned; o: (B, Lq, H, 16) bf16 contiguous; lse: (B * H, Lq)
// f32; kv_lengths: (B,) int32 or null. key_width: N, a multiple of 16 up
// to 128 (ops/flash_attention.py:d16_key_tiles). tiles_per_cta: the 128-row
// query tiles a CTA walks; heads_per_cta: G, a divisor of H up to 8 whose
// K and V fit in shared memory; 0 for the kernel's own plan. scale > 0.
inline cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                          const long long* sq, const long long* sk,
                          const long long* sv, bf16* o, float* lse,
                          const int* kv_lengths, int B, int H, int Lq, int Lk,
                          float scale, int causal, int key_width,
                          int tiles_per_cta, int heads_per_cta,
                          cudaStream_t st) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || !(scale > 0.f) ||
      key_width < 16 || key_width > kMaxKeyWidth || key_width % 16 != 0)
    return cudaErrorInvalidValue;
  const int nkt = (Lk + key_width - 1) / key_width;
  const int G = heads_per_cta > 0 ? heads_per_cta
                                  : auto_group(H, nkt, key_width);
  if (G > kMaxGroup || H % G != 0 || (long long)B * (H / G) > 65535)
    return cudaErrorInvalidValue;
  // (head-dim column, row, head, batch)
  CUtensorMap tq, tk, tv;
  if (!view_map(&tq, q, sq, B, H, Lq, kBQ, G) ||
      !view_map(&tk, k, sk, B, H, Lk, key_width, G) ||
      !view_map(&tv, v, sv, B, H, Lk, key_width, G))
    return cudaErrorInvalidValue;
  Params prm{};
  prm.kv_lengths = kv_lengths;
  prm.o = o;
  prm.lse = lse;
  prm.heads = H;
  prm.Lq = Lq;
  prm.Lk = Lk;
  prm.group = G;
  prm.nqt = (Lq + kBQ - 1) / kBQ;
  prm.nkt = nkt;
  prm.scale = scale;
  prm.sc2 = scale * LOG2E;
  prm.causal = causal;
  return by_width(key_width, [&](auto n) {
    return launch_width<decltype(n)::value>(tq, tk, tv, prm, B,
                                            tiles_per_cta, st);
  });
}

}  // namespace flash_d16
}  // namespace ivlm
