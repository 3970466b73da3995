// SAM global attention with the decomposed relative-position bias at head
// dim 80 on Hopper's own machinery (sm_90a): wgmma products fed by TMA
// through an mbarrier ring. Launched by ivlm_rel_attn (rel_attention.cu) on
// the "sm90" route, which ops/sam_attention.py:rel_route picks for D = 80,
// the ViT-H head dim; 16, 32 and 64 stay on the mma.sync core.
//
// Replaces, at D = 80, the Pallas TPU kernel
// interactvlm_tpu/ops/sam_attention.py `_kernel` (wrapper
// `fused_rel_attention`): softmax(q k^T D^-1/2 + bias) v over an H x W
// token grid (L = H W <= 64 x 64), with
//   bias[q, c] = rel_h[c / W, q] + rel_w[q, c % W],
// rel_h (BH, H, L) and rel_w (BH, L, W) from two einsums outside the
// kernel. The (L, L) bias never exists in memory.
//
// What bounds it on the H100: 4 L^2 D flops a (image, head) row, 5.4 Gflop
// at L = 4096, against ~2.6 MB of q, k, v, o and factors: the tensor cores.
// At D = 80 the softmax costs nearly as much as the products: a 64 x 64
// score tile is 1.3 Mflop of wgmma and 4096 exps, and at 989 Tflop/s
// against ~3.9 T exps/s the exps take ~80 % of the products' time; with
// the bias, the max, the sums and the bf16 packing, the softmax's
// instructions are what the card runs out of first. The design:
// - a CTA takes 128 query rows: two consumer warpgroups of 64 rows each and
//   a producer warp whose warpgroup gives its registers to them
//   (setmaxnreg). TMA brings Q once, and K and V tiles of 64 keys through a
//   4-deep ring (a full and an empty barrier a stage). The CTAs of one
//   (batch*head) row start their walks over the key tiles at different
//   tiles, so they do not all ask for the same lines at once;
// - D = 80 is two panels of 64 columns, 128 bytes a row, 128-byte swizzled,
//   one TMA box a panel; TMA zero-fills columns 80-127 of the second and
//   reads only the 80 that exist. (Boxes of 16-column panels, 32 bytes a
//   row, cost less shared memory but cut each tile into 2.5 times as many
//   row requests, and those then set the pace.) The products are trimmed
//   to 80: S = Q K^T is five wgmma m64n64k16 steps over the head dim (four
//   in the first panel, one in the second), both operands K-major; O += P V
//   is four m64n80k16 steps with P from registers (the S accumulators of
//   two neighbouring 8-key blocks are the A fragment of a 16-key step) and
//   V an MN-major operand, N = 80 over the two panels;
// - the two consumer warpgroups take turns on the tensor cores, ordered by
//   two named barriers: a turn issues S of this tile and P V of the last
//   one, then hands over, so one warpgroup's softmax runs under the other's
//   products. Inside a warpgroup, the exps of this tile run while P V of
//   the last is still in the tensor cores: only O's rescale and the new P
//   fragments wait for it. Each warpgroup's loop is compiled for its own
//   index, so its descriptors and barrier ids are uniform;
// - the softmax works in log2 units: the logits scaled by D^-1/2 log2 e in
//   one fma, then exp2. O and the row sums are rescaled only when a row's
//   max passes the offset they are kept against by more than 2^8 (so P
//   stays below 256), which after the first tiles is rare; each thread
//   adds its part of a row sum across its quad once, at the end;
// - the bias factors come from shared memory, where each CTA stages its
//   128 rows' rel_h columns and rel_w rows once. On a 64-wide grid (ViT-H's
//   64 x 64) a key tile is one grid row kh: each thread keeps its rel_w
//   columns, times log2 e, in registers for the whole loop, and rel_h[kh, q]
//   is one constant a row a tile, which moves into the max and the
//   exponent's offset instead of into every logit. Other grids rebuild each
//   element's bias by index arithmetic and mask the keys past L;
// - rows past L come zero-filled from TMA and are not written.
#pragma once

#include "attention_core.cuh"
#include "sm90_core.cuh"

namespace ivlm {
namespace rel_sm90 {

using namespace ivlm::sm90;

constexpr int kD = 80;
constexpr int kPanelCols = 64;         // head-dim columns a 128-byte row
constexpr int kPanels = 2;             // columns 0-63, 64-79 (80-127 zero)
constexpr int kBQ = 128;               // query rows a CTA: two warpgroups
constexpr int kBKeys = 64;             // keys a K or V tile
constexpr int kStages = 4;             // K/V tiles in flight
constexpr int kThreads = 384;          // warpgroups 0, 1 consume; 2 produces
constexpr int kMaxSide = 64;           // largest grid height or width
constexpr int kQPanel = kBQ * 128;      // bytes of one panel of Q
constexpr int kKVPanel = kBKeys * 128;  // ... of a K or V tile
constexpr int kQBytes = kPanels * kQPanel;
constexpr int kKVBytes = kPanels * kKVPanel;
constexpr int kStageBytes = 2 * kKVBytes;  // a stage: K's tile, then V's
constexpr int kRwPitch = kMaxSide + 8;  // a staged rel_w row, 16-byte aligned
constexpr int kFactorBytes = (kMaxSide * kBQ + kBQ * kRwPitch) * 2;
constexpr int kSmem = 1024 + kQBytes + kStages * kStageBytes + kFactorBytes +
                      8 * (1 + 2 * kStages);
// named barriers: consumer warpgroup w's turn on the tensor cores is
// kBarTurn + w; the two consumers' factor staging is kBarFactors
constexpr int kBarTurn = 1, kBarFactors = 3;

struct Params {
  const bf16* rel_h;  // (BH, H, L)
  const bf16* rel_w;  // (BH, L, W)
  bf16* o;            // (BH, L, 80)
  int L, H, W;
  float scale;
};

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

// S = Q K^T for one warpgroup's 64 rows and a 64-key tile: five k16 steps
// over the head dim, four in the first panel (32 bytes apart inside a
// swizzled row) and one in the second. dq, dk: K-major descriptors of the
// warpgroup's Q rows and of the K tile.
__device__ __forceinline__ void issue_s(float (&s)[32], uint64_t dq,
                                        uint64_t dk) {
  wgmma_bf16_ss_n64_set(s, dq, dk);
#pragma unroll
  for (int kk = 1; kk < kD / 16; ++kk)
    wgmma_bf16_ss_n64(s, desc_at(dq, (kk / 4) * kQPanel + (kk % 4) * 32),
                      desc_at(dk, (kk / 4) * kKVPanel + (kk % 4) * 32), 1);
}

// O += P V: a step a 16 keys; V's rows are keys (K), its 128-byte panels
// head-dim columns (N), of which the product reads 80. dv: the MN-major
// descriptor of the V tile.
__device__ __forceinline__ void issue_pv(float (&o)[40],
                                         const uint32_t (&pa)[4][4],
                                         uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < kBKeys / 16; ++kk)
    wgmma_bf16_rs_n80_tb(o, pa[kk], desc_at(dv, kk * 16 * 128), 1);
}

// The max (Max) or sum of the 16 columns a thread holds of one row, e = 0
// for its first row and 2 for its second, as a tree.
template <bool Max>
__device__ __forceinline__ float row_reduce(const float (&s)[32], int e) {
  float t[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    t[j] = Max ? fmaxf(s[4 * j + e], s[4 * j + e + 1])
               : s[4 * j + e] + s[4 * j + e + 1];
#pragma unroll
  for (int w = 1; w < 8; w *= 2)
#pragma unroll
    for (int j = 0; j < 8; j += 2 * w)
      t[j] = Max ? fmaxf(t[j], t[j + w]) : t[j] + t[j + w];
  return t[0];
}

// How far (log2 units) a row's max may pass the offset its P, O and l
// are kept against before they are rescaled: P stays below 2^8.
constexpr float kLazyRescale = 8.f;

// The online softmax of key tile kt on the S accumulators of this thread's
// rows l0r and l1r of the CTA, up to P in f32 in s. The row sums are kept
// against the offset m (log2 units), each thread's part l of them; the
// offset moves only where some row of the warp has passed it by more than
// kLazyRescale, so most tiles keep it. Returns whether it moved: then l is
// rescaled here and O must be by al0 and al1 (rescale_o_pack_p). Before the
// first tile m = -inf. o / l at the end is the same whatever the offsets.
template <bool kGrid64>
__device__ __forceinline__ bool softmax_p(
    float (&s)[32], float& m0, float& m1, float& l0, float& l1, float& al0,
    float& al1, const float (&rw2)[32], const bf16 (*rh_s)[kBQ],
    const bf16 (*rw_s)[kRwPitch], int kt, int l0r, int l1r, int tig, int L,
    int W, float sc2) {
  // the row's rel_h term in log2 units where it is constant over the tile
  float b0 = 0.f, b1 = 0.f;
  if constexpr (kGrid64) {
    b0 = bf(rh_s[kt][l0r]) * LOG2E;
    b1 = bf(rh_s[kt][l1r]) * LOG2E;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = fmaf(s[i], sc2, rw2[i]);
  } else {
    const int kbase = kt * kBKeys;
#pragma unroll
    for (int j = 0; j < kBKeys / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = kbase + 8 * j + 2 * tig + h;
        if (c < L) {
          const int kh = c / W, kw = c - kh * W;
          s[4 * j + h] =
              fmaf(s[4 * j + h], sc2,
                   (bf(rh_s[kh][l0r]) + bf(rw_s[l0r][kw])) * LOG2E);
          s[4 * j + 2 + h] =
              fmaf(s[4 * j + 2 + h], sc2,
                   (bf(rh_s[kh][l1r]) + bf(rw_s[l1r][kw])) * LOG2E);
        } else {
          s[4 * j + h] = neg_inf();
          s[4 * j + 2 + h] = neg_inf();
        }
      }
    }
  }
  // the thread's part of each row's max: a row's max passes the offset iff
  // one of its quad's parts does, so the quad's max is taken only then
  float mx0 = row_reduce<true>(s, 0) + b0, mx1 = row_reduce<true>(s, 2) + b1;
  const bool moved = __any_sync(
      0xffffffffu, mx0 > m0 + kLazyRescale || mx1 > m1 + kLazyRescale);
  if (moved) {
    // every tile holds a key below L, so the maxima are finite
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    al0 = exp2_ftz(m0 - mn0);
    al1 = exp2_ftz(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
  }
  const float off0 = m0 - b0, off1 = m1 - b1;
#pragma unroll
  for (int j = 0; j < kBKeys / 8; ++j) {
    s[4 * j + 0] = exp2_ftz(s[4 * j + 0] - off0);
    s[4 * j + 1] = exp2_ftz(s[4 * j + 1] - off0);
    s[4 * j + 2] = exp2_ftz(s[4 * j + 2] - off1);
    s[4 * j + 3] = exp2_ftz(s[4 * j + 3] - off1);
  }
  l0 += row_reduce<false>(s, 0);
  l1 += row_reduce<false>(s, 2);
  return moved;
}

// O rescaled where softmax_p moved the offset, and P rounded to bf16 A
// fragments for the next P V: both only after the last P V has finished
// with O and with the old fragments.
__device__ __forceinline__ void rescale_o_pack_p(float (&o)[40],
                                                 uint32_t (&pa)[4][4],
                                                 const float (&s)[32],
                                                 bool moved, float al0,
                                                 float al1) {
  if (moved) {
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[4 * j + 0] *= al0;
      o[4 * j + 1] *= al0;
      o[4 * j + 2] *= al1;
      o[4 * j + 3] *= al1;
    }
  }
#pragma unroll
  for (int kk = 0; kk < kBKeys / 16; ++kk) {
    pa[kk][0] = pack_f32(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_f32(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_f32(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_f32(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// What a consumer warpgroup reads of its CTA.
struct Tiles {
  uint64_t dq, dk0, dv0;  // descriptors: the warpgroup's Q rows, stage 0's K, V
  uint64_t *q_full, *full, *empty;
  const bf16 (*rh_s)[kBQ];
  const bf16 (*rw_s)[kRwPitch];
  int ntiles, t0;  // key tiles; the walk's first tile
  __device__ __forceinline__ int key_tile(int kt) const {
    const int t = kt + t0;
    return t < ntiles ? t : t - ntiles;
  }
};

// Consumer warpgroup WG (a constant, so its descriptors and barrier ids are
// uniform): rows q0 + 64 WG .. q0 + 64 WG + 63 of the CTA.
template <bool kGrid64, int WG>
__device__ __forceinline__ void consume(const Tiles& t, const Params& p,
                                        int q0, int bh) {
  const int L = p.L;
  const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int l0r = WG * 64 + warp * 16 + g, l1r = l0r + 8;
  const float sc2 = p.scale * LOG2E;
  float rw2[32];  // the grid-64 route's rel_w columns, times log2 e
  if constexpr (kGrid64) {
#pragma unroll
    for (int j = 0; j < kBKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rw2[4 * j + e] =
            bf(t.rw_s[e < 2 ? l0r : l1r][8 * j + 2 * tig + (e & 1)]) * LOG2E;
  }

  float o[40], s[32];
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < 40; ++i) o[i] = 0.f;
  float m0 = neg_inf(), m1 = neg_inf(), l0 = 0.f, l1 = 0.f;
  constexpr int mine = kBarTurn + WG, other = kBarTurn + (WG ^ 1);

  // Turns: warpgroup 0 goes first. Each warpgroup takes ntiles + 1 turns
  // (S of tile 0; S of tile kt with P V of tile kt - 1; P V of the last
  // tile) and hands over after each, but warpgroup 1 not after its last,
  // having handed the first turn over before it starts.
  if (WG == 1) bar_arrive(kBarTurn, 256);
  mbar_wait(t.q_full, 0);
  mbar_wait(&t.full[0], 0);
  bar_sync(mine, 256);
  wgmma_fence();
  issue_s(s, t.dq, t.dk0);
  wgmma_commit();
  bar_arrive(other, 256);
  wgmma_wait<0>();
  fence_regs(s);
  float al0 = 1.f, al1 = 1.f;
  bool moved = softmax_p<kGrid64>(s, m0, m1, l0, l1, al0, al1, rw2, t.rh_s,
                                  t.rw_s, t.key_tile(0), l0r, l1r, tig, L,
                                  p.W, sc2);
  rescale_o_pack_p(o, pa, s, moved, al0, al1);

  for (int kt = 1; kt < t.ntiles; ++kt) {
    // one barrier a stage: K and V of tile kt have landed, and V of tile
    // kt - 1 with its K
    const int ps = (kt - 1) % kStages, st = kt % kStages;
    mbar_wait(&t.full[st], (kt / kStages) & 1);
    bar_sync(mine, 256);
    wgmma_fence();
    issue_s(s, t.dq, desc_at(t.dk0, st * kStageBytes));
    wgmma_commit();
    issue_pv(o, pa, desc_at(t.dv0, ps * kStageBytes));
    wgmma_commit();
    bar_arrive(other, 256);
    // S of this tile is in; P V of the last runs on under the exps
    wgmma_wait<1>();
    fence_regs(s);
    moved = softmax_p<kGrid64>(s, m0, m1, l0, l1, al0, al1, rw2, t.rh_s,
                               t.rw_s, t.key_tile(kt), l0r, l1r, tig, L, p.W,
                               sc2);
    wgmma_wait<0>();
    fence_regs(o);
    if ((threadIdx.x & 127) == 0) mbar_arrive(&t.empty[ps]);
    rescale_o_pack_p(o, pa, s, moved, al0, al1);
  }

  const int ls = (t.ntiles - 1) % kStages;
  bar_sync(mine, 256);
  wgmma_fence();
  issue_pv(o, pa, desc_at(t.dv0, ls * kStageBytes));
  wgmma_commit();
  if (WG == 0) bar_arrive(other, 256);
  wgmma_wait<0>();
  fence_regs(o);

  // each row's sum over its quad's columns
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + l0r, r1 = q0 + l1r;
  bf16* ob = p.o + (size_t)bh * L * kD;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int col = 8 * j + 2 * tig;
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * kD + col) =
          pack_f32(o[4 * j + 0] * inv0, o[4 * j + 1] * inv0);
    if (r1 < L)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * kD + col) =
          pack_f32(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

// kGrid64: W = 64, a key tile is one grid row
template <bool kGrid64>
__global__ void __launch_bounds__(kThreads, 1)
    rel_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;              // kPanels panels of 128 rows
  unsigned char* kv = smem + kQBytes;    // kStages stages: K's tile, V's
  bf16(*rh_s)[kBQ] = reinterpret_cast<bf16(*)[kBQ]>(kv + kStages * kStageBytes);
  bf16(*rw_s)[kRwPitch] = reinterpret_cast<bf16(*)[kRwPitch]>(rh_s + kMaxSide);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(rw_s + kBQ);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int L = p.L;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  // The CTAs of one (batch*head) row would read the same K/V tiles at the
  // same moment; each starts its walk over the key tiles at its own tile
  // instead (the online softmax takes the keys in any order): tile kt of
  // the walk is key tile key_tile(kt).
  const int ntiles = (L + kBKeys - 1) / kBKeys;
  const Tiles t{0, 0, 0, q_full, full, empty, rh_s, rw_s, ntiles,
                static_cast<int>(blockIdx.x * ntiles / gridDim.x)};
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every TMA load, a box a panel
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(q_full, kQBytes);
      for (int c = 0; c < kPanels; ++c)
        tma_load_3d(qs + c * kQPanel, &tq, q_full, kPanelCols * c, q0, bh);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < ntiles; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* kd = kv + stage * kStageBytes;
        unsigned char* vd = kd + kKVBytes;
        const int key = t.key_tile(kt) * kBKeys;
        mbar_arrive_expect_tx(&full[stage], kStageBytes);
        for (int c = 0; c < kPanels; ++c) {
          tma_load_3d(kd + c * kKVPanel, &tk, &full[stage], kPanelCols * c,
                      key, bh);
          tma_load_3d(vd + c * kKVPanel, &tv, &full[stage], kPanelCols * c,
                      key, bh);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers
  setmaxnreg_inc<240>();

  // stage the factors of rows q0 .. q0 + 127, zero past L:
  // rh_s[kh][ql] = rel_h[kh, q0 + ql], rw_s[ql][kw] = rel_w[q0 + ql, kw]
  {
    const int ct = threadIdx.x;  // 0 .. 255
    const int rows = min(kBQ, L - q0);
    const bf16* rh = p.rel_h + (size_t)bh * p.H * L;
    const bf16* rw = p.rel_w + (size_t)bh * L * p.W + (size_t)q0 * p.W;
    if (L % 8 == 0 && p.W % 8 == 0) {
      // 16-byte vectors: 8 query rows of rel_h are all inside L or all past
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 4
      for (int i = ct; i < p.H * (kBQ / 8); i += 256) {
        const int kh = i / (kBQ / 8), c = (i % (kBQ / 8)) * 8;
        *reinterpret_cast<uint4*>(&rh_s[kh][c]) =
            c < rows ? *reinterpret_cast<const uint4*>(rh + (size_t)kh * L +
                                                       q0 + c)
                     : zero;
      }
      const int wv = p.W / 8;
#pragma unroll 4
      for (int i = ct; i < kBQ * wv; i += 256) {
        const int ql = i / wv, c = (i % wv) * 8;
        *reinterpret_cast<uint4*>(&rw_s[ql][c]) =
            ql < rows
                ? *reinterpret_cast<const uint4*>(rw + (size_t)ql * p.W + c)
                : zero;
      }
    } else {
      const bf16 zero = __float2bfloat16(0.f);
      for (int i = ct; i < p.H * kBQ; i += 256) {
        const int kh = i / kBQ, ql = i % kBQ;
        rh_s[kh][ql] = ql < rows ? rh[(size_t)kh * L + q0 + ql] : zero;
      }
      for (int i = ct; i < kBQ * p.W; i += 256) {
        const int ql = i / p.W, kw = i % p.W;
        rw_s[ql][kw] = ql < rows ? rw[(size_t)ql * p.W + kw] : zero;
      }
    }
  }
  bar_sync(kBarFactors, 256);

  Tiles mt = t;
  mt.dk0 = desc_kmajor(smem_addr(kv));
  mt.dv0 = desc_sw128(smem_addr(kv + kKVBytes), kKVPanel, 1024);
  if (wg == 0) {
    mt.dq = desc_kmajor(smem_addr(qs));
    consume<kGrid64, 0>(mt, p, q0, bh);
  } else {
    mt.dq = desc_kmajor(smem_addr(qs) + 64 * 128);
    consume<kGrid64, 1>(mt, p, q0, bh);
  }
}

// q/k/v/o: (bh, L, 80) bf16 contiguous, 16-byte aligned, L = H W;
// rel_h: (bh, H, L), rel_w: (bh, L, W) bf16; H, W <= 64.
inline cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                          const bf16* rel_h, const bf16* rel_w, bf16* o,
                          int bh, int L, int H, int W, float scale,
                          cudaStream_t st) {
  if (bh > 65535 || H > kMaxSide || W > kMaxSide || L != H * W)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  const cuuint64_t dims[3] = {kD, (cuuint64_t)L, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {kD * 2, (cuuint64_t)L * kD * 2};
  const cuuint32_t bq[3] = {kPanelCols, kBQ, 1};
  const cuuint32_t bk[3] = {kPanelCols, kBKeys, 1};
  const CUtensorMapDataType t = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode_sw128(&tq, t, 3, q, dims, strides, bq) ||
      !encode_sw128(&tk, t, 3, k, dims, strides, bk) ||
      !encode_sw128(&tv, t, 3, v, dims, strides, bk))
    return cudaErrorInvalidValue;
  const auto kernel = W == kMaxSide ? rel_fwd_sm90_kernel<true>
                                    : rel_fwd_sm90_kernel<false>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const Params prm{rel_h, rel_w, o, L, H, W, scale};
  const dim3 grid((L + kBQ - 1) / kBQ, bh);
  kernel<<<grid, kThreads, kSmem, st>>>(tq, tk, tv, prm);
  return cudaGetLastError();
}

}  // namespace rel_sm90
}  // namespace ivlm
