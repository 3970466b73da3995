// Flash attention backward for head dim 16 on Hopper's own machinery
// (sm_90a): wgmma products fed by TMA, reading q, k, v, o and dO where the
// projections leave them and writing dq, dk and dv where their backward
// reads. Launched by ivlm_flash_bwd_d16_dq and ivlm_flash_bwd_d16_dkv
// (flash_attention_bwd.cu); head dim 128 takes flash_bwd_sm90.cuh, 32 and
// 64 the mma.sync kernels of flash_attention_bwd.cu.
//
// Replaces, at D = 16, the Pallas TPU kernels
// interactvlm_tpu/ops/flash_attention.py `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (wrapper `_flash_backward`): P = exp(S scale - lse)
// recomputed from the forward's f32 logsumexp and masked as the forward
// masks, D = rowsum(dO O) in f32, dS = P (dP - D) with dP = dO V^T,
// dQ = scale dS K, dK = scale dS^T Q, dV = P^T dO; P and dS rounded to bf16
// as the products' operands. A row that sees no key gives dQ = 0.
//
// Where it runs: the SAM decoder's image -> token attention in every
// training step (B*V = 32 images, 8 heads, Lq = 4096 image tokens, Lk = 9
// prompt tokens), and the fusion's image -> LLaVA attention (Lk up to 512).
//
// The plan (key width, heads a CTA, K/V residency, query tiles a CTA,
// one pass or two kernels) is ops/flash_attention.py:d16_bwd_plan's alone;
// the launchers here only refuse a plan their kernels cannot run.
//
// What bounds it on the H100: at Lk = 9 the bytes (q, o, dO read and dq
// written, 33.5 MB each: ~0.041 ms at 3.35 TB/s for the whole backward);
// at Lk = 512 the exponentials (5.4e8 a pass over the pairs on the
// special-function units, 16 a clock an SM: ~0.128 ms). The mma.sync
// kernels this replaces ran 64-key tiles (55 of 64 keys masked at
// Lk = 9), read q, dO and lse twice (once for dq, once for dk/dv) with a
// dsum round trip and a split walk with a reduce launch, staged K and V
// with plain loads between barriers, and took contiguous copies of q, k, v,
// o and dO. Here:
// - key tiles trimmed to the keys: 16 ceil(Lk / (16 t)) wide for the fewest
//   tiles t of at most 64 keys (ops/flash_attention.py:d16_bwd_key_tiles):
//   one 16-key tile at Lk = 9, so a row recomputes 16 exponentials, not 64.
//   S = Q K^T and dP = dO V^T are each one wgmma m64nNk16 from TMA-fed
//   shared memory in the 32-byte swizzle (d16_sm90.cuh, the forward's
//   descriptors); dQ += dS K is N / 16 wgmma m64n16k16 with dS from
//   registers and K's tile an MN-major B, as the forward's O += P V;
// - at Lk <= 16 one pass (the fused route): a CTA (one warpgroup) walks a
//   run of 128-row query tiles of G heads (2 where H is even) with K and V
//   resident, computes P, dP and dS once, writes dQ, and accumulates its
//   heads' dK and dV (16 x 16 each) in registers. Both 64-row halves of a
//   tile go under one wait for S and dP and one for dQ (the forward's pair
//   step, at key tiles up to kPairMaxWidth); two query tiles in flight
//   (rows_stages); runs sized to
//   one wave of the card (4 CTAs an SM at the SAM decoder's shape: longer
//   runs or more waves measured slower). Those two products have
//   only 16 keys, so a 64-row wgmma would pad them 4x: each warp runs
//   them on its own 16 rows with mma.sync m16n8k16, P^T and dS^T turned
//   from the S accumulator's fragments by movmatrix.trans, dO and Q read
//   as B fragments by ldmatrix.trans from the swizzled tiles. At the end
//   the warps' sums are added in warp order and the CTA writes them to an
//   f32 workspace (run, B*H, 2, 16, 16); a second launch adds the runs in
//   order and writes dK and dV: the same bits from run to run. So q, o, dO
//   and lse are read once, D never leaves the CTA, and the only other
//   traffic is the workspace (a few MB);
// - past 16 keys two kernels, as at D = 128: the dq kernel is the same CTA
//   without the dK/dV products (K and V resident for a run of query tiles,
//   or, where the plan says they do not fit, streamed through a ring for
//   one tile a CTA),
//   and writes D = rowsum(dO O) for the dk/dv kernel; one query tile in
//   flight (rows_stages); the dk/dv kernel takes 64 keys of one
//   head a CTA and walks the query tiles through a ring of 4, 64 rows a
//   step, S^T = K Q^T and dP^T = V dO^T on wgmma (keys are its 64 rows), so
//   P^T and dS^T land in registers as the A fragments of dV += P^T dO and
//   dK += dS^T Q, each N = 16 wgmma from the tiles TMA brought (32-row
//   steps, at fewer registers and more CTAs an SM, measured slower).
//   Several CTAs an SM, one warpgroup each, so one's exponentials run under
//   another's products;
// - q, k, v, o and dO are 4-D tensor maps (head-dim column, row, head,
//   batch) over the views' strides, rows past L zero-filled by TMA; dq is
//   staged in its query slot once the tile's products are done and leaves
//   in 16-byte stores a thread over G x 32 bytes of each row of
//   (B, Lq, H, 16), dk and dv in 16-byte stores over rows of (B, Lk, H, 16),
//   so the projections' backward reads all three as views.
#pragma once

#include <algorithm>
#include <type_traits>

#include "attention_core.cuh"
#include "d16_sm90.cuh"
#include "sm90_core.cuh"

namespace ivlm {
namespace flash_bwd_d16 {

using namespace ivlm::sm90;
using namespace ivlm::d16_sm90;

constexpr int kD = 16;
constexpr int kRowBytes = 32;  // one row of q, k, v, o or dO
constexpr int kBQ = 128;       // query rows a tile: two halves of 64
constexpr int kQTileBytes = kBQ * kRowBytes;
constexpr int kThreads = 128;  // one warpgroup
constexpr int kPairMaxWidth = 32;  // both halves a step up to this key width
constexpr int kPartKeys = 16;  // keys a one-pass partial holds: one tile
constexpr int kRingSlots = 4;  // key tiles in flight where K, V stream
constexpr int kDkvKeys = 64;   // keys a dk/dv CTA
constexpr int kDkvStep = 64;   // query rows a dk/dv step
constexpr int kDkvStages = 4;  // query tiles in flight a dk/dv CTA
constexpr int kMaxSmem = 232448;

// ---- mma.sync helpers of the fused route's small products

// The transpose of an 8 x 8 bf16 matrix held as mma fragments (a thread
// holds row lane / 4, columns 2 (lane % 4) and + 1) in the same layout.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d)
               : "r"(a));
  return d;
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lanes 8 i ..
// 8 i + 7 give the rows of matrix i; a thread receives, of each, elements
// (2 (lane % 4), lane / 4) and (2 (lane % 4) + 1, lane / 4): the B fragment
// of mma.m16n8k16 whose K runs along the rows.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// ---- the rows kernel: dQ (and, fused, the dK/dV partials)

struct RowsParams {
  const float* lse;        // (B * H, Lq)
  float* dsum;             // (B * H, Lq): D, for the dk/dv kernel; fused: null
  bf16* dq;                // (B, Lq, H, 16)
  float* part;             // fused: (runs, B * H, 2, 16, 16); else null
  const int* kv_lengths;   // (B,) or null
  int heads, Lq, Lk;
  int nqt;                 // query tiles of a (b, h)
  int tiles_per_cta;       // query tiles a CTA walks
  int nkt;                 // key tiles of Lk
  int kv_slots;            // key tiles held; resident iff >= nkt
  float scale;
  float sc2;               // scale * log2 e
  int causal;
};

// D = rowsum(dO O) of tile rows tr and tr + 8 in f32: a thread of the
// quad takes four columns of each (4 tig .. 4 tig + 3), the quad adds.
__device__ __forceinline__ void row_dsum(const unsigned char* dot,
                                         const unsigned char* ot, int tr,
                                         int tig, float (&d)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t off = sw32_offset(tr + 8 * i, tig >> 1) + (tig & 1) * 8;
    const uint2 a = *reinterpret_cast<const uint2*>(dot + off);
    const uint2 b = *reinterpret_cast<const uint2*>(ot + off);
    float x = dot2(a.y, b.y, dot2(a.x, b.x, 0.f));
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    d[i] = x;
  }
}

// P = exp(S scale - lse), masked, into s and dS = P (dP - D) into dp, for
// one half (64 query rows from `hrow`) against one key tile from `kbase`:
// s[4 j + e] at row r0 (e < 2) or r0 + 8, key kbase + 8 j + 2 tig + e % 2.
// nl: -lse log2 e, d: D, of this thread's rows r0 and r0 + 8.
template <int N>
__device__ __forceinline__ void softmax_ds(float (&s)[N / 2],
                                          float (&dp)[N / 2], int kbase,
                                          int hrow, int kvl, int offset,
                                          const RowsParams& p,
                                          const float (&nl)[2],
                                          const float (&d)[2], int warp,
                                          int lane) {
  const int g = lane >> 2, tig = lane & 3;
  const bool edge = kbase + N > kvl || hrow + 64 > p.Lq ||
                    (p.causal && kbase + N - 1 > hrow + offset);
  const int r0 = hrow + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float pv = exp2_ftz(fmaf(s[4 * j + e], p.sc2, nl[h]));
      if (edge) {
        const int c = kbase + 8 * j + 2 * tig + (e & 1);
        const int r = r0 + 8 * h;
        if (c >= kvl || r >= p.Lq || (p.causal && c > r + offset)) pv = 0.f;
      }
      s[4 * j + e] = pv;
      dp[4 * j + e] = pv * (dp[4 * j + e] - d[h]);
    }
  }
}

// The fused route's dV += P^T dO and dK += dS^T Q over this warp's 16 rows
// of one half (dO's rows at da, Q's at qa), on mma.sync m16n8k16 (M = the
// 16 keys, K = the rows): P^T and dS^T from the 8 x 8 blocks (rows 0-7 |
// 8-15) x (keys 0-7 | 8-15) of the accumulator, each transposed; dO and Q
// as B fragments (K = rows, N = head dim), matrices (rows 0-7 | 8-15) x
// (columns 0-7 | 8-15).
__device__ __forceinline__ void small_products(const float (&s)[8],
                                              const float (&dp)[8],
                                              uint32_t qa, uint32_t da,
                                              int warp, int lane,
                                              float (&dk)[2][4],
                                              float (&dv)[2][4]) {
  uint32_t pt[4], st[4];
  pt[0] = movmatrix_trans(pack_f32(s[0], s[1]));
  pt[1] = movmatrix_trans(pack_f32(s[4], s[5]));
  pt[2] = movmatrix_trans(pack_f32(s[2], s[3]));
  pt[3] = movmatrix_trans(pack_f32(s[6], s[7]));
  st[0] = movmatrix_trans(pack_f32(dp[0], dp[1]));
  st[1] = movmatrix_trans(pack_f32(dp[4], dp[5]));
  st[2] = movmatrix_trans(pack_f32(dp[2], dp[3]));
  st[3] = movmatrix_trans(pack_f32(dp[6], dp[7]));
  const int lr = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t off = sw32_offset(lr, lane >> 4);
  uint32_t bo[4], bq[4];
  ldmatrix_x4_trans(bo, da + off);
  ldmatrix_x4_trans(bq, qa + off);
  mma16816(dv[0], pt, bo[0], bo[1]);
  mma16816(dv[1], pt, bo[2], bo[3]);
  mma16816(dk[0], st, bq[0], bq[1]);
  mma16816(dk[1], st, bq[2], bq[3]);
}

// dQ += dS K for one half, issued (no fence, commit or wait): two
// neighbouring 8-key blocks of dS are the A fragment of a k16 step; K's
// tile rows are keys (K), its 32 bytes the head dim (N).
template <int N>
__device__ __forceinline__ void dq_product(const float (&dp)[N / 2],
                                          uint32_t ka, float (&dq)[8],
                                          uint32_t (&sa)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    sa[kk][0] = pack_f32(dp[8 * kk + 0], dp[8 * kk + 1]);
    sa[kk][1] = pack_f32(dp[8 * kk + 2], dp[8 * kk + 3]);
    sa[kk][2] = pack_f32(dp[8 * kk + 4], dp[8 * kk + 5]);
    sa[kk][3] = pack_f32(dp[8 * kk + 6], dp[8 * kk + 7]);
  }
  const uint64_t kd = desc_sw32(ka, N * kRowBytes, 256);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_bf16_rs_n16_tb(dq, sa[kk], desc_at(kd, kk * 16 * kRowBytes), 1);
}

// One half (64 query rows from `hrow`, at qa and da in shared memory)
// against one key tile (K at ka, V at va): S and dP, P and dS, fused the
// small products, then dQ += dS K, waited for.
template <int N, bool kFused>
__device__ __forceinline__ void half_step(
    uint32_t qa, uint32_t da, uint32_t ka, uint32_t va, int kbase, int hrow,
    int kvl, int offset, const RowsParams& p, const float (&nl)[2],
    const float (&d)[2], int warp, int lane, float (&dq)[8],
    float (&dk)[2][4], float (&dv)[2][4]) {
  float s[N / 2], dp[N / 2];
  wgmma_fence();
  s_set(s, desc_sw32(qa, 16, 256), desc_sw32(ka, 16, 256));
  s_set(dp, desc_sw32(da, 16, 256), desc_sw32(va, 16, 256));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  softmax_ds<N>(s, dp, kbase, hrow, kvl, offset, p, nl, d, warp, lane);
  if constexpr (kFused) {
    static_assert(N == 16, "the fused route takes one 16-key tile");
    small_products(s, dp, qa, da, warp, lane, dk, dv);
  }
  uint32_t sa[N / 16][4];
  wgmma_fence();
  dq_product<N>(dp, ka, dq, sa);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dq);
}

// Both halves of a 128-row tile (rows from q0; Q at qa, dO at da) against
// one key tile, their products issued together: one wait for the four S
// and dP products, one for the two dQ products. At narrow key tiles the
// chain of waits, not the work, sets a tile's time (the forward's pair
// step). A half the causal mask hides from the whole tile runs too: every
// one of its elements is masked, so it adds nothing.
template <int N, bool kFused>
__device__ __forceinline__ void pair_step(
    uint32_t qa, uint32_t da, uint32_t ka, uint32_t va, int kbase, int q0,
    int kvl, int offset, const RowsParams& p, const float (&nl)[2][2],
    const float (&d)[2][2], int warp, int lane, float (&dq)[2][8],
    float (&dk)[2][4], float (&dv)[2][4]) {
  float s0[N / 2], dp0[N / 2], s1[N / 2], dp1[N / 2];
  constexpr uint32_t kHalf = 64 * kRowBytes;
  const uint64_t kdesc = desc_sw32(ka, 16, 256);
  const uint64_t vdesc = desc_sw32(va, 16, 256);
  wgmma_fence();
  s_set(s0, desc_sw32(qa, 16, 256), kdesc);
  s_set(dp0, desc_sw32(da, 16, 256), vdesc);
  s_set(s1, desc_sw32(qa + kHalf, 16, 256), kdesc);
  s_set(dp1, desc_sw32(da + kHalf, 16, 256), vdesc);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s0);
  fence_regs(dp0);
  fence_regs(s1);
  fence_regs(dp1);
  softmax_ds<N>(s0, dp0, kbase, q0, kvl, offset, p, nl[0], d[0], warp, lane);
  softmax_ds<N>(s1, dp1, kbase, q0 + 64, kvl, offset, p, nl[1], d[1], warp,
                lane);
  if constexpr (kFused) {
    static_assert(N == 16, "the fused route takes one 16-key tile");
    small_products(s0, dp0, qa, da, warp, lane, dk, dv);
    small_products(s1, dp1, qa + kHalf, da + kHalf, warp, lane, dk, dv);
  }
  uint32_t sa0[N / 16][4], sa1[N / 16][4];
  wgmma_fence();
  dq_product<N>(dp0, ka, dq[0], sa0);
  dq_product<N>(dp1, ka, dq[1], sa1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dq[0]);
  fence_regs(dq[1]);
}

// One half's dQ (tile rows tr, tr + 8 of this thread), scaled and rounded,
// into its head's query tile (whose products are done): tile row r at
// r xor (gi % 4), so the CTA's row-major copy out reads four heads' rows
// from distinct banks (the forward's staging).
__device__ __forceinline__ void stage_dq(const float (&dq)[8],
                                         unsigned char* qt, int tr, int gi,
                                         float scale, int tig) {
  unsigned char* s0 = qt + (tr ^ (gi & 3)) * kRowBytes + 4 * tig;
  unsigned char* s1 = qt + ((tr + 8) ^ (gi & 3)) * kRowBytes + 4 * tig;
  *reinterpret_cast<uint32_t*>(s0) = pack_f32(dq[0] * scale, dq[1] * scale);
  *reinterpret_cast<uint32_t*>(s1) = pack_f32(dq[2] * scale, dq[3] * scale);
  *reinterpret_cast<uint32_t*>(s0 + 16) =
      pack_f32(dq[4] * scale, dq[5] * scale);
  *reinterpret_cast<uint32_t*>(s1 + 16) =
      pack_f32(dq[6] * scale, dq[7] * scale);
}

// Query tiles in flight a CTA: two in the one pass; one in the dq kernel,
// so 4 CTAs fit an SM beside the fusion's 32 KB of K and V (two fit 3 and
// measured slower).
__host__ __device__ constexpr int rows_stages(bool fused) {
  return fused ? 2 : 1;
}

template <int N, int G, bool kFused>
__global__ void __launch_bounds__(kThreads, (kFused ? 4 : 3))
    flash_bwd_d16_rows_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap to,
                              const __grid_constant__ CUtensorMap tdo,
                              RowsParams p) {
  constexpr int kHeads = G * kQTileBytes;  // one tensor's tiles of G heads
  constexpr int kStage = 3 * kHeads;       // q, dO and o
  constexpr int kKVStage = G * N * kRowBytes;
  constexpr int kStages = rows_stages(kFused);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;
  unsigned char* ks = qs + kStages * kStage;
  unsigned char* vs = ks + p.kv_slots * kKVStage;
  float* dsum_stage = reinterpret_cast<float*>(vs + p.kv_slots * kKVStage);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(dsum_stage + G * kBQ);
  uint64_t* kv_full = q_full + kStages;

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
    prefetch_tmap(&to);
    prefetch_tmap(&tdo);
    for (int s = 0; s < kStages; ++s) mbar_init(&q_full[s], 1);
    for (int s = 0; s < p.kv_slots; ++s) mbar_init(&kv_full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();

  // thread 0 issues every load: one box of G heads a key tile of K and of
  // V, and a query tile of q, dO and o
  const CUtensorMap* mq = &tq;
  const CUtensorMap* mk = &tk;
  const CUtensorMap* mv = &tv;
  const CUtensorMap* mo = &to;
  const CUtensorMap* mdo = &tdo;
  auto load_kv = [&](int slot, int kt) {
    mbar_arrive_expect_tx(&kv_full[slot], 2 * kKVStage);
    tma_load_4d(ks + slot * kKVStage, mk, &kv_full[slot], 0, kt * N, h0, b);
    tma_load_4d(vs + slot * kKVStage, mv, &kv_full[slot], 0, kt * N, h0, b);
  };
  auto load_q = [&](int j) {
    const int slot = j % kStages;
    unsigned char* st = qs + slot * kStage;
    const int row = (t0 + j) * kBQ;
    mbar_arrive_expect_tx(&q_full[slot], kStage);
    tma_load_4d(st, mq, &q_full[slot], 0, row, h0, b);
    tma_load_4d(st + kHeads, mdo, &q_full[slot], 0, row, h0, b);
    tma_load_4d(st + 2 * kHeads, mo, &q_full[slot], 0, row, h0, b);
  };
  if (tid == 0) {
    // resident: the run's last query tile needs the most keys; streaming
    // (one tile a CTA): the ring's first key tiles
    const int n = tiles_for(t0 + nt - 1);
    for (int kt = 0; kt < (resident ? n : min(n, p.kv_slots)); ++kt)
      load_kv(kt, kt);
    for (int j = 0; j < nt && j < kStages; ++j) load_q(j);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  float dk[G][2][4], dv[G][2][4];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[gi][nb][e] = dv[gi][nb][e] = 0.f;

  for (int j = 0; j < nt; ++j) {
    const int q0 = (t0 + j) * kBQ;
    const int slot = j % kStages;
    const int nk = tiles_for(t0 + j);
    unsigned char* stage = qs + slot * kStage;
    mbar_wait(&q_full[slot], (j / kStages) & 1);
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      unsigned char* qt = stage + gi * kQTileBytes;
      const unsigned char* dot = qt + kHeads;
      const unsigned char* ot = qt + 2 * kHeads;
      const float* lrow = p.lse + (size_t)(b * p.heads + h0 + gi) * p.Lq;
      float nl[2][2], dd[2][2], dq[2][8];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int tr = 64 * hf + warp * 16 + g;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = q0 + tr + 8 * i;
          nl[hf][i] = r < p.Lq ? -lrow[r] * LOG2E : 0.f;
        }
        row_dsum(dot, ot, tr, tig, dd[hf]);
        if (!kFused && tig == 0) {
          dsum_stage[gi * kBQ + tr] = dd[hf][0];
          dsum_stage[gi * kBQ + tr + 8] = dd[hf][1];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) dq[hf][i] = 0.f;
      }
      for (int kt = 0; kt < nk; ++kt) {
        const int ks_slot = resident ? kt : kt % p.kv_slots;
        mbar_wait(&kv_full[ks_slot], resident ? 0 : (kt / p.kv_slots) & 1);
        const uint32_t ka =
            smem_addr(ks + ks_slot * kKVStage + gi * N * kRowBytes);
        const uint32_t va =
            smem_addr(vs + ks_slot * kKVStage + gi * N * kRowBytes);
        if constexpr (N <= kPairMaxWidth) {
          pair_step<N, kFused>(smem_addr(qt), smem_addr(dot), ka, va, kt * N,
                               q0, kvl, offset, p, nl, dd, warp, lane, dq,
                               dk[gi], dv[gi]);
        } else {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int hrow = q0 + 64 * hf;
            // under the causal mask the half sees keys below hrow + 64 +
            // offset
            if (p.causal && kt * N >= hrow + 64 + offset) continue;
            half_step<N, kFused>(smem_addr(qt) + hf * 64 * kRowBytes,
                                 smem_addr(dot) + hf * 64 * kRowBytes, ka,
                                 va, kt * N, hrow, kvl, offset, p, nl[hf],
                                 dd[hf], warp, lane, dq[hf], dk[gi], dv[gi]);
          }
        }
        if (!resident) {
          __syncthreads();  // every warp's products on the slot are done
          if (tid == 0 && kt + p.kv_slots < nk)
            load_kv(ks_slot, kt + p.kv_slots);
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        stage_dq(dq[hf], qt, 64 * hf + warp * 16 + g, gi, p.scale, tig);
    }
    __syncthreads();  // the tile's dq (and D) are staged
    // the tile out in 16-byte stores a thread: dq row by row, G heads' 32
    // bytes each; D four rows a store where they are aligned and inside Lq
    const int rows = min(kBQ, p.Lq - q0);
    for (int k = tid; k < rows * 2 * G; k += kThreads) {
      const int row = k / (2 * G), hc = k - row * 2 * G;
      const int gi = hc >> 1, c = hc & 1;
      const uint4 val = *reinterpret_cast<const uint4*>(
          stage + gi * kQTileBytes + (row ^ (gi & 3)) * kRowBytes + 16 * c);
      *reinterpret_cast<uint4*>(
          p.dq + (((size_t)b * p.Lq + q0 + row) * p.heads + h0 + gi) * kD +
          8 * c) = val;
    }
    if (!kFused) {
      for (int k = tid; k < G * kBQ / 4; k += kThreads) {
        const int gi = k / (kBQ / 4), r = 4 * (k - gi * (kBQ / 4));
        if (r >= rows) continue;
        const float* src = dsum_stage + gi * kBQ + r;
        float* dst =
            p.dsum + (size_t)(b * p.heads + h0 + gi) * p.Lq + q0 + r;
        if (r + 3 < rows && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
          *reinterpret_cast<float4*>(dst) =
              *reinterpret_cast<const float4*>(src);
        } else {
          for (int i = 0; i < 4 && r + i < rows; ++i) dst[i] = src[i];
        }
      }
    }
    // the staging reads come before the next TMA write of the slot
    fence_proxy_async();
    __syncthreads();
    if (tid == 0 && j + kStages < nt) load_q(j + kStages);
  }

  if constexpr (kFused) {
    // each warp's dK and dV over its rows into shared memory (the ring is
    // free: every load was waited for), then the warps' sums added in warp
    // order, to the workspace: (run, B * H, 2, 16, 16), this CTA's G heads
    // adjacent
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);
    static_assert(4 * G * 2 * 256 * 4 <= kStage, "reduction");
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = g + 8 * (e >> 1), col = 8 * nb + 2 * tig + (e & 1);
          float* w = red + (warp * G + gi) * 512 + key * 16 + col;
          w[0] = dk[gi][nb][e];
          w[256] = dv[gi][nb][e];
        }
    __syncthreads();
    const float4* r4 = reinterpret_cast<const float4*>(red);
    float4* out = reinterpret_cast<float4*>(
        p.part + ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * G * 512);
    for (int i = tid; i < G * 128; i += kThreads) {
      float4 a = r4[i];
#pragma unroll
      for (int w = 1; w < 4; ++w) {
        const float4 x = r4[w * G * 128 + i];
        a.x += x.x;
        a.y += x.y;
        a.z += x.z;
        a.w += x.w;
      }
      out[i] = a;
    }
  }
}

// dK = scale (sum of the runs' partials), dV = their sum, each in run
// order, into (B, Lk, H, 16): a thread takes 8 columns of one key of dK or
// dV of one (b, h).
__global__ void flash_bwd_d16_reduce_kernel(const float* __restrict__ part,
                                            bf16* __restrict__ dk,
                                            bf16* __restrict__ dv, int runs,
                                            int bh_count, int heads, int Lk,
                                            float scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= bh_count * Lk * 4) return;
  const int c = i & 1, which = (i >> 1) & 1, rest = i >> 2;
  const int key = rest % Lk, bh = rest / Lk;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int r = 0; r < runs; ++r) {
    const float4* src = reinterpret_cast<const float4*>(
        part + (((size_t)r * bh_count + bh) * 2 + which) * 256 + key * 16 +
        8 * c);
    const float4 a = src[0], b = src[1];
    acc[0] += a.x;
    acc[1] += a.y;
    acc[2] += a.z;
    acc[3] += a.w;
    acc[4] += b.x;
    acc[5] += b.y;
    acc[6] += b.z;
    acc[7] += b.w;
  }
  const float f = which == 0 ? scale : 1.f;
  uint4 o;
  o.x = pack_f32(acc[0] * f, acc[1] * f);
  o.y = pack_f32(acc[2] * f, acc[3] * f);
  o.z = pack_f32(acc[4] * f, acc[5] * f);
  o.w = pack_f32(acc[6] * f, acc[7] * f);
  const int b = bh / heads, h = bh - b * heads;
  *reinterpret_cast<uint4*>((which == 0 ? dk : dv) +
                            (((size_t)b * Lk + key) * heads + h) * kD +
                            8 * c) = o;
}

// ---- the dk/dv kernel (after the dq kernel)

struct DkvParams {
  const float* lse;   // (B * H, Lq)
  const float* dsum;  // (B * H, Lq), from the dq kernel
  bf16* dk;           // (B, Lk, H, 16)
  bf16* dv;
  const int* kv_lengths;
  int heads, Lq, Lk, nqt;
  float scale, sc2;
  int causal;
};

__global__ void __launch_bounds__(kThreads, 3)
    flash_bwd_d16_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             DkvParams p) {
  constexpr int kStage = 2 * kQTileBytes;  // q and dO
  constexpr int kKeyBytes = kDkvKeys * kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;
  unsigned char* ks = qs + kDkvStages * kStage;
  unsigned char* vs = ks + kKeyBytes;
  float* nls = reinterpret_cast<float*>(vs + kKeyBytes);  // -lse log2 e
  float* ds = nls + kBQ;                                    // D
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ds + kBQ);
  uint64_t* kv_full = q_full + kDkvStages;

  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int k0 = blockIdx.x * kDkvKeys;
  const int offset = p.Lk - p.Lq;
  int kvl = p.Lk;
  if (p.kv_lengths != nullptr) kvl = min(kvl, p.kv_lengths[b]);
  kvl = max(kvl, 0);
  // the first query that sees key k0 is k0 - offset under causal
  const int qstart = p.causal ? max(0, k0 - offset) / kBQ : 0;
  const int ntiles = k0 < kvl ? max(0, p.nqt - qstart) : 0;
  const float* lrow = p.lse + (size_t)bh * p.Lq;
  const float* drow = p.dsum + (size_t)bh * p.Lq;

  const int tid = threadIdx.x;
  if (tid == 0) {
    prefetch_tmap(&tq);
    prefetch_tmap(&tk);
    prefetch_tmap(&tv);
    prefetch_tmap(&tdo);
    for (int s = 0; s < kDkvStages; ++s) mbar_init(&q_full[s], 1);
    mbar_init(kv_full, 1);
    fence_barrier_init();
  }
  __syncthreads();
  const CUtensorMap* mq = &tq;
  const CUtensorMap* mdo = &tdo;
  auto load_q = [&](int jj) {
    const int slot = jj % kDkvStages;
    unsigned char* st = qs + slot * kStage;
    const int row = (qstart + jj) * kBQ;
    mbar_arrive_expect_tx(&q_full[slot], kStage);
    tma_load_4d(st, mq, &q_full[slot], 0, row, h, b);
    tma_load_4d(st + kQTileBytes, mdo, &q_full[slot], 0, row, h, b);
  };
  if (tid == 0 && ntiles > 0) {
    mbar_arrive_expect_tx(kv_full, 2 * kKeyBytes);
    tma_load_4d(ks, &tk, kv_full, 0, k0, h, b);
    tma_load_4d(vs, &tv, kv_full, 0, k0, h, b);
    for (int jj = 0; jj < ntiles && jj < kDkvStages; ++jj) load_q(jj);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;
  const uint32_t ka = smem_addr(ks), va = smem_addr(vs);
  float dk[8], dv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) dk[i] = dv[i] = 0.f;
  // a tile's -lse log2 e and D go global -> registers -> shared memory,
  // the next tile's loads issued before this tile's products
  float ln = 0.f, dn = 0.f;
  auto fetch = [&](int jj) {
    const int r = (qstart + jj) * kBQ + tid;
    ln = r < p.Lq ? -lrow[r] * LOG2E : 0.f;
    dn = r < p.Lq ? drow[r] : 0.f;
  };
  if (ntiles > 0) {
    fetch(0);
    mbar_wait(kv_full, 0);
  }
  for (int jj = 0; jj < ntiles; ++jj) {
    const int q0 = (qstart + jj) * kBQ;
    const int slot = jj % kDkvStages;
    __syncthreads();  // every warp is done with the previous tile
    if (tid == 0 && jj > 0 && jj - 1 + kDkvStages < ntiles)
      load_q(jj - 1 + kDkvStages);  // into the slot the last tile freed
    nls[tid] = ln;
    ds[tid] = dn;
    __syncthreads();
    if (jj + 1 < ntiles) fetch(jj + 1);
    mbar_wait(&q_full[slot], (jj / kDkvStages) & 1);
    const uint32_t qt = smem_addr(qs + slot * kStage);
    const uint32_t dt = qt + kQTileBytes;
#pragma unroll
    for (int sh = 0; sh < kBQ / kDkvStep; ++sh) {
      const int rbase = q0 + kDkvStep * sh;
      // a step past Lq, or whose rows all lie before the first that sees
      // key k0, adds nothing
      if (rbase >= p.Lq || (p.causal && rbase + kDkvStep - 1 < k0 - offset))
        continue;
      const uint32_t qa = qt + sh * kDkvStep * kRowBytes;
      const uint32_t da = dt + sh * kDkvStep * kRowBytes;
      // S^T = K Q^T and dP^T = V dO^T: rows are this CTA's 64 keys
      float s[kDkvStep / 2], dp[kDkvStep / 2];
      wgmma_fence();
      s_set(s, desc_sw32(ka, 16, 256), desc_sw32(qa, 16, 256));
      s_set(dp, desc_sw32(va, 16, 256), desc_sw32(da, 16, 256));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // s[4 j + e]: key key0 (e < 2) or key1, query rbase + 8 j + 2 tig +
      // e % 2
      const bool edge = k0 + kDkvKeys > kvl || rbase + kDkvStep > p.Lq ||
                        (p.causal && k0 + kDkvKeys - 1 > rbase + offset);
#pragma unroll
      for (int j = 0; j < kDkvStep / 8; ++j) {
        const int col = kDkvStep * sh + 8 * j + 2 * tig;
        const float2 l2 = *reinterpret_cast<const float2*>(nls + col);
        const float2 d2 = *reinterpret_cast<const float2*>(ds + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float li = (e & 1) ? l2.y : l2.x;
          const float di = (e & 1) ? d2.y : d2.x;
          float pv = exp2_ftz(fmaf(s[4 * j + e], p.sc2, li));
          if (edge) {
            const int r = q0 + col + (e & 1);
            const int key = (e & 2) ? key1 : key0;
            if (r >= p.Lq || key >= kvl || (p.causal && key > r + offset))
              pv = 0.f;
          }
          s[4 * j + e] = pv;
          dp[4 * j + e] = pv * (dp[4 * j + e] - di);
        }
      }
      // dV += P^T dO and dK += dS^T Q: neighbouring 8-query blocks of P^T
      // and dS^T are the A fragments of a k16 step over the queries; dO's
      // and Q's rows are queries (K), their 32 bytes the head dim (N)
      uint32_t pa[kDkvStep / 16][4], sa[kDkvStep / 16][4];
#pragma unroll
      for (int kk = 0; kk < kDkvStep / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[kk][i] = pack_f32(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
          sa[kk][i] = pack_f32(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
        }
      }
      const uint64_t dd = desc_sw32(da, kDkvStep * kRowBytes, 256);
      const uint64_t qd = desc_sw32(qa, kDkvStep * kRowBytes, 256);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDkvStep / 16; ++kk) {
        wgmma_bf16_rs_n16_tb(dv, pa[kk], desc_at(dd, kk * 16 * kRowBytes), 1);
        wgmma_bf16_rs_n16_tb(dk, sa[kk], desc_at(qd, kk * 16 * kRowBytes), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
    }
  }

  // dK (scaled) and dV, rounded, staged row by row over the K and V tiles
  // (every product that read them is done), then out in 16-byte stores
  __syncthreads();
  unsigned char* kst = ks;
  unsigned char* vst = vs;
  const int kr = warp * 16 + g;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int cb = (8 * j + 2 * tig) * 2;
    *reinterpret_cast<uint32_t*>(kst + kr * kRowBytes + cb) =
        pack_f32(dk[4 * j + 0] * p.scale, dk[4 * j + 1] * p.scale);
    *reinterpret_cast<uint32_t*>(kst + (kr + 8) * kRowBytes + cb) =
        pack_f32(dk[4 * j + 2] * p.scale, dk[4 * j + 3] * p.scale);
    *reinterpret_cast<uint32_t*>(vst + kr * kRowBytes + cb) =
        pack_f32(dv[4 * j + 0], dv[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(vst + (kr + 8) * kRowBytes + cb) =
        pack_f32(dv[4 * j + 2], dv[4 * j + 3]);
  }
  __syncthreads();
  for (int i = tid; i < 2 * kDkvKeys * 2; i += kThreads) {
    const int which = i / (kDkvKeys * 2), rem = i - which * kDkvKeys * 2;
    const int row = rem >> 1, c = rem & 1;
    const int key = k0 + row;
    if (key >= p.Lk) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(
        (which ? vst : kst) + row * kRowBytes + 16 * c);
    *reinterpret_cast<uint4*>((which ? p.dv : p.dk) +
                              (((size_t)b * p.Lk + key) * p.heads + h) * kD +
                              8 * c) = val;
  }
}

// ---- host side

// Lets a kernel launch with `smem` bytes of dynamic shared memory and reads
// the CTAs an SM then holds, once for each (kernel, size, device): the
// kernels share one signature, so the cache is keyed by the function's
// address, and a kernel's limit only rises (the attribute is the kernel's,
// not the launch's: a smaller size set after a larger one would refuse the
// larger launch).
template <class K>
inline cudaError_t prepare(K kernel, int smem, int* per_sm) {
  struct Entry {
    const void* fn;
    int smem, dev, per_sm;
  };
  struct Limit {
    const void* fn;
    int dev, smem;
  };
  static Entry cache[64];
  static Limit limits[32];
  static int used = 0, nlimits = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < used; ++i)
    if (cache[i].fn == fn && cache[i].smem == smem && cache[i].dev == dev) {
      *per_sm = cache[i].per_sm;
      return cudaSuccess;
    }
  int li = 0;
  while (li < nlimits && !(limits[li].fn == fn && limits[li].dev == dev)) ++li;
  if (li == nlimits || limits[li].smem < smem) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (li < nlimits) {
      limits[li].smem = smem;
    } else if (nlimits < 32) {
      limits[nlimits++] = Limit{fn, dev, smem};
    }
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (used < 64) cache[used++] = Entry{fn, smem, dev, *per_sm};
  return cudaSuccess;
}

// The rows kernel's key-tile slots (every tile where the plan keeps K and
// V of the G heads resident, else a ring) and shared memory.
inline void rows_layout(int N, int G, int nkt, bool fused, bool resident,
                        int* kv_slots, int* smem) {
  const int kv = 2 * G * N * kRowBytes;
  *kv_slots = resident ? nkt : kRingSlots;
  *smem = 1024 + rows_stages(fused) * (3 * G * kQTileBytes + 8) +
          *kv_slots * (kv + 8) + G * kBQ * (int)sizeof(float);
}

inline int dkv_smem() {
  return 1024 + kDkvStages * (2 * kQTileBytes + 8) +
         2 * kDkvKeys * kRowBytes + 2 * kBQ * (int)sizeof(float) + 8;
}

// Calls f(std::integral_constant<int, N>{}, std::integral_constant<int,
// G>{}, std::integral_constant<bool, F>{}) for the rows kernel's variants:
// fused (N = 16, G = 1 or 2) or not (G = 1, N = 32 .. 64: past 16 keys
// the plan's tiles are never 16 wide).
template <class F>
inline cudaError_t by_variant(int fused, int N, int G, F f) {
  using std::integral_constant;
  if (fused) {
    if (N != 16) return cudaErrorInvalidValue;
    if (G == 1)
      return f(integral_constant<int, 16>{}, integral_constant<int, 1>{},
               integral_constant<bool, true>{});
    if (G == 2)
      return f(integral_constant<int, 16>{}, integral_constant<int, 2>{},
               integral_constant<bool, true>{});
    return cudaErrorInvalidValue;
  }
  if (G != 1) return cudaErrorInvalidValue;
  switch (N) {
#define IVLM_BWD_D16_WIDTH(NN)                                          \
  case NN:                                                              \
    return f(integral_constant<int, NN>{}, integral_constant<int, 1>{}, \
             integral_constant<bool, false>{});
    IVLM_BWD_D16_WIDTH(32)
    IVLM_BWD_D16_WIDTH(48)
    IVLM_BWD_D16_WIDTH(64)
#undef IVLM_BWD_D16_WIDTH
    default:
      return cudaErrorInvalidValue;
  }
}

// The CTAs an SM holds of the rows kernel (fused or not; key width N, G
// heads, nkt key tiles, K and V resident or streamed).
inline cudaError_t blocks_per_sm(int fused, int N, int G, int nkt,
                                 int resident, int* per_sm) {
  if (nkt <= 0) return cudaErrorInvalidValue;
  return by_variant(fused, N, G, [&](auto n, auto gg, auto ff) {
    int slots = 0, smem = 0;
    rows_layout(N, G, nkt, fused != 0, resident != 0, &slots, &smem);
    return prepare(flash_bwd_d16_rows_kernel<decltype(n)::value,
                                             decltype(gg)::value,
                                             decltype(ff)::value>,
                   smem, per_sm);
  });
}

// The rows kernel. q, k, v, o, dO: (B, H, L, 16) bf16 views (element
// strides s[0] batch, s[1] head, s[2] row, multiples of 8, unit stride on
// the head dim, 16-byte aligned); lse: (B * H, Lq) f32; dq: (B, Lq, H, 16)
// bf16; the one pass where part is given: part (runs, B * H, 2, 16, 16)
// f32 with runs = ceil(ceil(Lq / 128) / tiles_per_cta), one 16-key tile,
// dsum null; else the dq kernel: dsum (B * H, Lq) f32. key_width (N),
// group (G heads a CTA), kv_resident (K and V of a CTA kept whole, else
// streamed: one head and one query tile a CTA) and tiles_per_cta (the
// 128-row query tiles a CTA walks): ops/flash_attention.py:d16_bwd_plan.
inline cudaError_t launch_rows(const bf16* q, const bf16* k, const bf16* v,
                               const bf16* o, const bf16* dO,
                               const long long* sq, const long long* sk,
                               const long long* sv, const long long* so,
                               const long long* sdo, const float* lse,
                               float* dsum, bf16* dq, float* part,
                               const int* kv_lengths, int B, int H, int Lq,
                               int Lk, float scale, int causal,
                               int key_width, int group, int kv_resident,
                               int tiles_per_cta, cudaStream_t st) {
  const bool fused = part != nullptr;
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || group <= 0 ||
      H % group != 0 || tiles_per_cta <= 0 || key_width <= 0 ||
      (long long)B * (H / group) > 65535 ||
      (fused && Lk > key_width) || (!fused && dsum == nullptr))
    return cudaErrorInvalidValue;
  const int nkt = (Lk + key_width - 1) / key_width;
  int kv_slots = 0, smem = 0;
  rows_layout(key_width, group, nkt, fused, kv_resident != 0, &kv_slots,
              &smem);
  // streaming K and V: one query tile and one head a CTA
  if (!kv_resident && (tiles_per_cta != 1 || group != 1))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, to, tdo;
  if (!view_map(&tq, q, sq, B, H, Lq, kBQ, group) ||
      !view_map(&tdo, dO, sdo, B, H, Lq, kBQ, group) ||
      !view_map(&to, o, so, B, H, Lq, kBQ, group) ||
      !view_map(&tk, k, sk, B, H, Lk, key_width, group) ||
      !view_map(&tv, v, sv, B, H, Lk, key_width, group))
    return cudaErrorInvalidValue;
  RowsParams prm{};
  prm.lse = lse;
  prm.dsum = fused ? nullptr : dsum;
  prm.dq = dq;
  prm.part = fused ? part : nullptr;
  prm.kv_lengths = kv_lengths;
  prm.heads = H;
  prm.Lq = Lq;
  prm.Lk = Lk;
  prm.nqt = (Lq + kBQ - 1) / kBQ;
  prm.tiles_per_cta = tiles_per_cta;
  prm.nkt = nkt;
  prm.kv_slots = kv_slots;
  prm.scale = scale;
  prm.sc2 = scale * LOG2E;
  prm.causal = causal;
  const dim3 grid((prm.nqt + tiles_per_cta - 1) / tiles_per_cta,
                  B * (H / group));
  return by_variant(fused, key_width, group, [&](auto n, auto gg, auto ff) {
    const auto kernel =
        flash_bwd_d16_rows_kernel<decltype(n)::value, decltype(gg)::value,
                                  decltype(ff)::value>;
    int per_sm = 0;
    cudaError_t err = prepare(kernel, smem, &per_sm);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, st>>>(tq, tk, tv, to, tdo, prm);
    return cudaGetLastError();
  });
}

// The fused route's second launch: dk, dv (B, Lk, H, 16) bf16 from the
// rows kernel's `runs` partials.
inline cudaError_t launch_reduce(const float* part, bf16* dk, bf16* dv,
                                 int runs, int B, int H, int Lk, float scale,
                                 cudaStream_t st) {
  if (runs <= 0 || B <= 0 || H <= 0 || Lk <= 0 || Lk > kPartKeys)
    return cudaErrorInvalidValue;
  const int n = B * H * Lk * 4;
  const int threads = 256;
  flash_bwd_d16_reduce_kernel<<<(n + threads - 1) / threads, threads, 0,
                                st>>>(part, dk, dv, runs, B * H, H, Lk,
                                      scale);
  return cudaGetLastError();
}

// The dk/dv kernel: q, k, v, dO views as for launch_rows; lse and dsum
// (B * H, Lq) f32 (dsum from the rows kernel, launched before on the same
// stream); dk, dv (B, Lk, H, 16) bf16.
inline cudaError_t launch_dkv(const bf16* q, const bf16* k, const bf16* v,
                              const bf16* dO, const long long* sq,
                              const long long* sk, const long long* sv,
                              const long long* sdo, const float* lse,
                              const float* dsum, bf16* dk, bf16* dv,
                              const int* kv_lengths, int B, int H, int Lq,
                              int Lk, float scale, int causal,
                              cudaStream_t st) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || (long long)B * H > 65535 ||
      dsum == nullptr)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  if (!view_map(&tq, q, sq, B, H, Lq, kBQ, 1) ||
      !view_map(&tdo, dO, sdo, B, H, Lq, kBQ, 1) ||
      !view_map(&tk, k, sk, B, H, Lk, kDkvKeys, 1) ||
      !view_map(&tv, v, sv, B, H, Lk, kDkvKeys, 1))
    return cudaErrorInvalidValue;
  DkvParams prm{};
  prm.lse = lse;
  prm.dsum = dsum;
  prm.dk = dk;
  prm.dv = dv;
  prm.kv_lengths = kv_lengths;
  prm.heads = H;
  prm.Lq = Lq;
  prm.Lk = Lk;
  prm.nqt = (Lq + kBQ - 1) / kBQ;
  prm.scale = scale;
  prm.sc2 = scale * LOG2E;
  prm.causal = causal;
  const int smem = dkv_smem();
  int per_sm = 0;
  cudaError_t err = prepare(flash_bwd_d16_dkv_kernel, smem, &per_sm);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lk + kDkvKeys - 1) / kDkvKeys, B * H);
  flash_bwd_d16_dkv_kernel<<<grid, kThreads, smem, st>>>(tq, tk, tv, tdo,
                                                         prm);
  return cudaGetLastError();
}

}  // namespace flash_bwd_d16
}  // namespace ivlm
