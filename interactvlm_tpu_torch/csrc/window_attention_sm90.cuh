// SAM window attention with the decomposed relative-position bias at head
// dim 80 on Hopper's own machinery (sm_90a): wgmma products fed by TMA
// through a two-stage mbarrier ring, one persistent CTA an SM. Launched by
// ivlm_window_attn (window_attention.cu) on the "sm90" route, which
// ops/sam_attention.py:window_route picks for D = 80 and windows of up to
// 16 x 16 (ViT-H's 14 x 14); other head dims stay on the mma.sync core.
//
// Replaces, at D = 80, the Pallas TPU kernel
// interactvlm_tpu/ops/sam_attention.py `_window_kernel` (wrapper
// `fused_window_attention`): each (window, head) row attends over its
// L = H W tokens with
//   bias[q, c] = f[c / W, q] + f[H + c % W, q],
// f (R, H+W, L) stacking rel_h and rel_w, the two einsums outside the
// kernel; softmax(q k^T D^-1/2 + bias) v in one pass over all keys, as the
// TPU kernel does.
//
// What bounds it on the H100: at ViT-H's window block (R = 12 800 rows,
// L = 196) a row moves ~137 KB (q, k, v, the factors, o) for 12.3 Mflop,
// ~90 flops a byte, so the bytes would: 0.52 ms a block at 3.35 TB/s. The
// card showed otherwise (probes/kernel_variants.py: knock-outs of this
// header built side by side, and clock64 stamps of one CTA's phases; an
// H100 80GB HBM3 at 700 W): the consumers' instruction stream sets the
// pace. The kernel takes 0.72 ms, 0.68 ms with its loads cut out; the
// loads alone take 0.42 ms (0.65 ms on the qkv linear's views). A 64-row
// query tile costs a consumer warpgroup ~2100-2500 clocks of softmax (the
// bias, the max, ~120 exps a thread on the SFUs, the sums, the bf16
// packing; 0.66 ms with the exps cut), ~1500 from issuing S to its result,
// ~600-1100 to issue P V's 28 products, ~500-1700 for its 20 output stores
// a thread. What paid while it was built: reading the factors from shared
// memory, filled by one bulk copy a row (each consumer thread read them
// from device memory, their latency sat between S and the softmax: 0.88 ->
// 0.72 ms); turns between the warpgroups (0.76 -> 0.72 ms); keeping ptxas
// from serializing the products (0.82 -> 0.72 ms, below). What did not: an
// L2 prefetch of each window's qkv block (slower), a copy loop for the
// factors on the producer's spare warps (slower: its loads waited one by
// one), L2 promotion off (no change). The design:
// - one crossing from device memory for every byte: a CTA takes a whole
//   (window, head) row, all its query tiles, so K and V are read once (the
//   mma.sync kernel's four query-tile CTAs read them four times);
// - persistent CTAs walk rows blockIdx.x, + gridDim.x, ...; a producer
//   thread issues the next row's TMA loads into the second stage while two
//   consumer warpgroups work on this one (setmaxnreg moves the producer
//   warpgroup's registers to them), the row's factors in one bulk copy
//   from the 16-byte boundary at or before them;
// - q, k and v are read where the qkv linear leaves them: the tensor maps
//   are encoded from the (window, head, token) strides of the views, and
//   o is written as (BW, L, nH, 80), so the caller's transpose back to
//   tokens costs no copy;
// - D = 80 is a 128-byte panel (columns 0-63, 128-byte swizzle) and a
//   32-byte panel (64-79, 32-byte swizzle): 160 bytes a row in shared
//   memory, two TMA row requests a row as with two 128-byte panels, but
//   ~100 KB a stage, so two stages fit;
// - K and V land in a key-slot layout of 16 slots a window row: slot
//   16 kh + kw holds token kh W + kw, slots kw >= W are TMA's zero fill
//   (a 5-D box over (column, kw, kh, head, window)). Then a thread's key
//   columns, fixed by the accumulator layout, have a compile-time kh and
//   one of four kw: the bias is rel_h[kh] of the row plus one of the
//   thread's four rel_w values, no division or shared load per logit, and
//   masking is free (-inf factors for kw >= W and kh >= H);
// - S = Q K^T is one wgmma m64nNk16 chain, N = 16 kH (224 for ViT-H: all
//   keys in one pass, five k16 steps over the two panels), one softmax a
//   row with no rescale, in log2 units (D^-1/2 log2 e and log2 e folded
//   into one fma a logit); P goes from registers into O += P V, a k16 step
//   a window row, as m64n64k16 (128-byte panel) plus m64n16k16 (32-byte
//   panel);
// - each consumer warpgroup takes the row's query tiles of 64 in turn
//   (tiles 0 and 2, 1 and 3), and the two take turns on the tensor cores
//   (named barriers, as in rel_attention_sm90.cuh): a turn issues S of a
//   tile or P V of one, so one warpgroup's softmax runs under the other's
//   products. Without the turns both leave each row's full barrier
//   together and run their softmax at the same moment, the tensor cores
//   idle. Q rows past L are zero fill or the next buffer's bytes: their
//   softmax runs and is never written. Control flow stays uniform over a
//   warp as far as ptxas can see (the warpgroup index goes through a
//   shuffle, no branch by warp writes a wgmma operand): otherwise it
//   serializes the products (warning C7520).
#pragma once

#include "attention_core.cuh"
#include "sm90_core.cuh"

namespace ivlm {
namespace win_sm90 {

using namespace ivlm::sm90;

constexpr int kD = 80;
constexpr int kColsA = 64;  // head-dim columns of the 128-byte panel
constexpr int kRowBytes = 160;  // a row of both panels in shared memory
constexpr int kSlots = 16;  // key slots a window row: kw < 16
constexpr int kMaxSide = 16;
constexpr int kThreads = 384;  // warpgroups 0, 1 consume; 2 produces
// named barriers: consumer warpgroup w's turn on the tensor cores
constexpr int kBarTurn = 1;

// Shared memory of one stage for key grids of kH rows (kH * 16 slots) and
// kQRows query rows: the 128-byte panels (1024-byte aligned), then the
// 32-byte panels (256-byte aligned). After the stages, each stage's factors
// (the row's (H + W, L) block, from the 16-byte boundary at or before it),
// then the barriers.
template <int kH, int kQRows>
struct Layout {
  static constexpr int kMaxF = kH == 14 ? 28 : 2 * kMaxSide;  // H + W
  static constexpr int kKeys = kSlots * kH;
  static constexpr int kK128 = 0;
  static constexpr int kV128 = kKeys * 128;
  static constexpr int kQ128 = 2 * kKeys * 128;
  static constexpr int kK32 = (2 * kKeys + kQRows) * 128;
  static constexpr int kV32 = kK32 + kKeys * 32;
  static constexpr int kQ32 = kV32 + kKeys * 32;
  static constexpr int kData = kQ32 + kQRows * 32;
  static constexpr int kStage = (kData + 1023) / 1024 * 1024;
  static constexpr int kFactors = kMaxF * kQRows * 2 + 32;  // a stage's
};

struct Params {
  const bf16* f;  // (R, H + W, L)
  bf16* o;        // (BW, L, nH, 80)
  int R, nH, L, H, W, Lq;  // Lq: the Q box's rows, L rounded up to 8
  float sc2;               // D^-1/2 log2 e
};

// S = Q K^T over kH * 16 key slots: the first step sets S.
template <int kH>
__device__ __forceinline__ void s_first(float (&s)[kH * 8], uint64_t a,
                                        uint64_t b) {
  if constexpr (kH == 14)
    wgmma_bf16_ss_n224_set(s, a, b);
  else
    wgmma_bf16_ss_n256_set(s, a, b);
}

template <int kH>
__device__ __forceinline__ void s_next(float (&s)[kH * 8], uint64_t a,
                                       uint64_t b) {
  if constexpr (kH == 14)
    wgmma_bf16_ss_n224(s, a, b, 1);
  else
    wgmma_bf16_ss_n256(s, a, b, 1);
}

__device__ __forceinline__ uint32_t u16(const bf16* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}

// a bf16 in f32 times log2 e
__device__ __forceinline__ float log2e_times(const bf16* p) {
  return __uint_as_float(u16(p) << 16) * LOG2E;
}

// The two consumer warpgroups take turns on the tensor cores, so that one's
// softmax runs under the other's products: warpgroup wg's turn waits on
// barrier kBarTurn + wg and hands over on the other's. Warpgroup 0 goes
// first (warpgroup 1 hands it the first turn before it starts); each takes
// `last` + 1 turns and hands over after each, but warpgroup 1 not after its
// last.
struct Turns {
  int mine, other, n, last;
  bool wg1;
  __device__ __forceinline__ void take() const { bar_sync(mine, 256); }
  __device__ __forceinline__ void pass() {
    if (n++ < last || !wg1) bar_arrive(other, 256);
  }
};

// One query tile t (rows 64 t .. 64 t + 63) of the row in the stage at
// shared address `b`: S on a turn, the softmax, P V on the next turn, and
// the rows below L written.
template <int kH, int kQRows>
__device__ __forceinline__ void tile(uint32_t b, int t, const bf16* fs,
                                     bf16* orow, const Params& p, int warp,
                                     int g, int tig, Turns& turns) {
  using Lay = Layout<kH, kQRows>;
  constexpr int kJ = kH * 2;  // 8-column accumulator blocks
  const int L = p.L, H = p.H, W = p.W;

  float s[kH * 8];
  const uint64_t dqa = desc_kmajor(b + Lay::kQ128 + t * 64 * 128);
  const uint64_t dka = desc_kmajor(b + Lay::kK128);
  turns.take();
  wgmma_fence();
  s_first<kH>(s, dqa, dka);
#pragma unroll
  for (int kk = 1; kk < kColsA / 16; ++kk)
    s_next<kH>(s, desc_at(dqa, kk * 32), desc_at(dka, kk * 32));
  s_next<kH>(s, desc_sw32(b + Lay::kQ32 + t * 64 * 32, 16, 256),
             desc_sw32(b + Lay::kK32, 16, 256));
  wgmma_commit();
  turns.pass();

  // the factors of this thread's rows, from the stage's copy (rows past L
  // read row L - 1's): rel_w of its four key columns kw = 8 (m / 2) +
  // 2 tig + m % 2 in log2 units, -inf past W; rel_h of every key grid row
  // kh, the two rows' values packed as a bf16 pair, -inf past H
  const int q0 = t * 64 + warp * 16 + g, q1 = q0 + 8;
  const bf16* f0 = fs + min(q0, L - 1);
  const bf16* f1 = fs + min(q1, L - 1);
  float fw0[4], fw1[4];
  uint32_t fh[kH];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int kw = 8 * (m >> 1) + 2 * tig + (m & 1);
    const bool in = kw < W;
    fw0[m] = in ? log2e_times(f0 + (H + kw) * L) : neg_inf();
    fw1[m] = in ? log2e_times(f1 + (H + kw) * L) : neg_inf();
  }
#pragma unroll
  for (int kh = 0; kh < kH; ++kh)
    fh[kh] = kh < H ? u16(f0 + kh * L) | (u16(f1 + kh * L) << 16)
                    : 0xff80ff80u;  // a pair of bf16 -inf

  wgmma_wait<0>();
  fence_regs(s);

  // s[4 j + e]: row q0 (e < 2) or q1, key slot 8 j + 2 tig + e % 2, which
  // is grid row j / 2 and rel_w term 2 (j % 2) + e % 2
  // Every warp runs the softmax, rows past L too: a branch by warp would
  // write the P fragments on a path that is not uniform over the
  // warpgroup, and ptxas then serializes the products.
  uint32_t pa[kH][4];
  float l0, l1;
  {
    float mx[4] = {neg_inf(), neg_inf(), neg_inf(), neg_inf()};
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const uint32_t ph = fh[j / 2];
      const float h0 = __uint_as_float(ph << 16) * LOG2E;
      const float h1 = __uint_as_float(ph & 0xffff0000u) * LOG2E;
      const int m = 2 * (j & 1);
      s[4 * j + 0] = fmaf(s[4 * j + 0], p.sc2, h0 + fw0[m]);
      s[4 * j + 1] = fmaf(s[4 * j + 1], p.sc2, h0 + fw0[m + 1]);
      s[4 * j + 2] = fmaf(s[4 * j + 2], p.sc2, h1 + fw1[m]);
      s[4 * j + 3] = fmaf(s[4 * j + 3], p.sc2, h1 + fw1[m + 1]);
      // two chains a row, so the maxima do not wait on each other
      mx[(j & 1)] = fmaxf(mx[(j & 1)], fmaxf(s[4 * j + 0], s[4 * j + 1]));
      mx[2 + (j & 1)] =
          fmaxf(mx[2 + (j & 1)], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    float m0 = fmaxf(mx[0], mx[1]), m1 = fmaxf(mx[2], mx[3]);
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kh = 0; kh < kH; ++kh) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float& x = s[8 * kh + i];
        x = exp2_ftz(x - ((i & 2) ? m1 : m0));
        sum[((i & 2) >> 1) * 2 + (kh & 1)] += x;
      }
      pa[kh][0] = pack_f32(s[8 * kh + 0], s[8 * kh + 1]);
      pa[kh][1] = pack_f32(s[8 * kh + 2], s[8 * kh + 3]);
      pa[kh][2] = pack_f32(s[8 * kh + 4], s[8 * kh + 5]);
      pa[kh][3] = pack_f32(s[8 * kh + 6], s[8 * kh + 7]);
    }
    l0 = sum[0] + sum[1];
    l1 = sum[2] + sum[3];
  }

  // O += P V: a k16 step a key grid row, over the two V panels (MN-major)
  float oa[32], ob[8];
#pragma unroll
  for (int i = 0; i < 32; ++i) oa[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) ob[i] = 0.f;
  const uint64_t dva = desc_sw128(b + Lay::kV128, Lay::kKeys * 128, 1024);
  const uint64_t dvb = desc_sw32(b + Lay::kV32, Lay::kKeys * 32, 256);
  turns.take();
  wgmma_fence();
#pragma unroll
  for (int kh = 0; kh < kH; ++kh) {
    wgmma_bf16_rs_n64_tb(oa, pa[kh], desc_at(dva, kh * kSlots * 128), 1);
    wgmma_bf16_rs_n16_tb(ob, pa[kh], desc_at(dvb, kh * kSlots * 32), 1);
  }
  wgmma_commit();
  turns.pass();
  wgmma_wait<0>();
  fence_regs(oa);
  fence_regs(ob);

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const size_t pitch = (size_t)p.nH * kD;  // one token to the next in o
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = r ? q1 : q0;
    if (q >= L) continue;
    const float inv = r ? inv1 : inv0;
    bf16* o = orow + (size_t)q * pitch + 2 * tig;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(o + 8 * j) =
          pack_f32(oa[4 * j + 2 * r] * inv, oa[4 * j + 2 * r + 1] * inv);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<uint32_t*>(o + kColsA + 8 * j) =
          pack_f32(ob[4 * j + 2 * r] * inv, ob[4 * j + 2 * r + 1] * inv);
  }
}

template <int kH, int kQRows, int kStages>
__global__ void __launch_bounds__(kThreads, 1)
    window_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tqa,
                           const __grid_constant__ CUtensorMap tqb,
                           const __grid_constant__ CUtensorMap tka,
                           const __grid_constant__ CUtensorMap tkb,
                           const __grid_constant__ CUtensorMap tva,
                           const __grid_constant__ CUtensorMap tvb,
                           Params p) {
  using Lay = Layout<kH, kQRows>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* factors = reinterpret_cast<bf16*>(smem + kStages * Lay::kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + kStages * (Lay::kStage + Lay::kFactors));
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();
  // the warpgroup, uniform as far as ptxas can see: from threadIdx.x alone
  // every branch on it is divergent to ptxas, which then serializes the
  // wgmma products inside
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (wg == 2) {
    // ---- producer: one thread issues every load, a box a panel and the
    // row's factors in one bulk copy
    setmaxnreg_dec<40>();
    if (threadIdx.x != 256) return;
    const uint32_t bytes = (p.Lq + 2 * Lay::kKeys) * kRowBytes;
    const size_t fbytes = (size_t)(p.H + p.W) * p.L * sizeof(bf16);
    int it = 0;
    for (int row = blockIdx.x; row < p.R; row += gridDim.x, ++it) {
      const int st = it % kStages;
      mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
      unsigned char* sb = smem + st * Lay::kStage;
      const int bw = row / p.nH, h = row - bw * p.nH;
      uint64_t* bar = &full[st];
      // the factors from the 16-byte boundary at or before the row's block
      // to the one at or after its end
      const uintptr_t f0 = reinterpret_cast<uintptr_t>(
          p.f + (size_t)row * (p.H + p.W) * p.L);
      const uintptr_t fa = f0 & ~uintptr_t(15);
      const uint32_t fn = (uint32_t)((f0 + fbytes + 15 - fa) & ~uintptr_t(15));
      mbar_arrive_expect_tx(bar, bytes + fn);
      bulk_load(factors + st * (Lay::kFactors / 2),
                reinterpret_cast<const void*>(fa), fn, bar);
      tma_load_4d(sb + Lay::kQ128, &tqa, bar, 0, 0, h, bw);
      tma_load_4d(sb + Lay::kQ32, &tqb, bar, kColsA, 0, h, bw);
      tma_load_5d(sb + Lay::kK128, &tka, bar, 0, 0, 0, h, bw);
      tma_load_5d(sb + Lay::kK32, &tkb, bar, kColsA, 0, 0, h, bw);
      tma_load_5d(sb + Lay::kV128, &tva, bar, 0, 0, 0, h, bw);
      tma_load_5d(sb + Lay::kV32, &tvb, bar, kColsA, 0, 0, h, bw);
    }
    return;
  }

  // ---- consumers: warpgroup wg takes query tiles wg, wg + 2, ... of an
  // even count (with an odd count of tiles below L, warpgroup 1's last one
  // is all past L), so both take the same number of turns
  setmaxnreg_inc<232>();
  const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int ntiles = (p.L + 127) / 128 * 2;
  const int rows = (p.R - blockIdx.x + gridDim.x - 1) / gridDim.x;
  Turns turns{kBarTurn + wg, kBarTurn + (wg ^ 1), 0, rows * ntiles - 1,
              wg == 1};
  if (wg == 1) bar_arrive(kBarTurn, 256);
  int it = 0;
  for (int row = blockIdx.x; row < p.R; row += gridDim.x, ++it) {
    const int st = it % kStages;
    mbar_wait(&full[st], (it / kStages) & 1);
    const uint32_t b = smem_addr(smem + st * Lay::kStage);
    const int bw = row / p.nH, h = row - bw * p.nH;
    // the row's factors sit at its block's offset from a 16-byte boundary
    const bf16* fs = reinterpret_cast<const bf16*>(
        reinterpret_cast<const unsigned char*>(factors) +
        st * Lay::kFactors +
        (reinterpret_cast<uintptr_t>(p.f + (size_t)row * (p.H + p.W) * p.L) &
         15));
    bf16* orow = p.o + ((size_t)bw * p.L * p.nH + h) * kD;
    for (int t = wg; t < ntiles; t += 2)
      tile<kH, kQRows>(b, t, fs, orow, p, warp, g, tig, turns);
    // this warpgroup's products on the stage have completed
    if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[st]);
  }
}

template <int kH, int kQRows, int kStages>
inline cudaError_t launch_variant(const bf16* q, const bf16* k, const bf16* v,
                                  const long long* sq, const long long* sk,
                                  const long long* sv, const Params& prm,
                                  int BW, cudaStream_t st) {
  using Lay = Layout<kH, kQRows>;
  // the last query tile of a 200-row Q reads 56 rows past its panels, into
  // the next stage's or the factors' bytes
  constexpr int kSmem =
      1024 + kStages * (Lay::kStage + Lay::kFactors) + 16 * kStages;
  const CUtensorMapDataType t = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle s128 = CU_TENSOR_MAP_SWIZZLE_128B;
  const CUtensorMapSwizzle s32 = CU_TENSOR_MAP_SWIZZLE_32B;
  // q: (column, token, head, window); k, v: (column, kw, kh, head, window)
  const cuuint64_t qdims[4] = {kD, (cuuint64_t)prm.L, (cuuint64_t)prm.nH,
                               (cuuint64_t)BW};
  const cuuint64_t qstr[3] = {(cuuint64_t)sq[2] * 2, (cuuint64_t)sq[1] * 2,
                              (cuuint64_t)sq[0] * 2};
  const cuuint64_t kdims[5] = {kD, (cuuint64_t)prm.W, (cuuint64_t)prm.H,
                               (cuuint64_t)prm.nH, (cuuint64_t)BW};
  auto kv_strides = [&](const long long* s, cuuint64_t* out) {
    out[0] = (cuuint64_t)s[2] * 2;
    out[1] = (cuuint64_t)s[2] * prm.W * 2;
    out[2] = (cuuint64_t)s[1] * 2;
    out[3] = (cuuint64_t)s[0] * 2;
  };
  cuuint64_t kstr[4], vstr[4];
  kv_strides(sk, kstr);
  kv_strides(sv, vstr);
  const cuuint32_t qa[4] = {kColsA, (cuuint32_t)prm.Lq, 1, 1};
  const cuuint32_t qb[4] = {kD - kColsA, (cuuint32_t)prm.Lq, 1, 1};
  const cuuint32_t ka[5] = {kColsA, kSlots, kH, 1, 1};
  const cuuint32_t kb[5] = {kD - kColsA, kSlots, kH, 1, 1};
  CUtensorMap tqa, tqb, tka, tkb, tva, tvb;
  if (!encode_swizzled(&tqa, t, 4, q, qdims, qstr, qa, s128) ||
      !encode_swizzled(&tqb, t, 4, q, qdims, qstr, qb, s32) ||
      !encode_swizzled(&tka, t, 5, k, kdims, kstr, ka, s128) ||
      !encode_swizzled(&tkb, t, 5, k, kdims, kstr, kb, s32) ||
      !encode_swizzled(&tva, t, 5, v, kdims, vstr, ka, s128) ||
      !encode_swizzled(&tvb, t, 5, v, kdims, vstr, kb, s32))
    return cudaErrorInvalidValue;
  const auto kernel = window_fwd_sm90_kernel<kH, kQRows, kStages>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const int sms = sm_count(), grid = prm.R < sms ? prm.R : sms;
  kernel<<<grid, kThreads, kSmem, st>>>(tqa, tqb, tka, tkb, tva, tvb, prm);
  return cudaGetLastError();
}

// q, k, v: (BW, nH, L, 80) bf16 views, unit stride on the head dim and
// element strides s[0] (window), s[1] (head), s[2] (token) that are
// multiples of 8, 16-byte aligned; f: (BW nH, H + W, L) bf16 contiguous;
// o: (BW, L, nH, 80) bf16 contiguous. H, W <= 16, L = H W.
inline cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                          const long long* sq, const long long* sk,
                          const long long* sv, const bf16* f, bf16* o, int BW,
                          int nH, int L, int H, int W, float scale,
                          cudaStream_t st) {
  if (BW <= 0 || nH <= 0 || H < 1 || W < 1 || H > kMaxSide ||
      W > kMaxSide || L != H * W)
    return cudaErrorInvalidValue;
  const int Lq = (L + 7) / 8 * 8;
  const Params prm{f, o, BW * nH, nH, L, H, W, Lq, scale * LOG2E};
  // ViT-H's 14 x 14 and smaller windows: 224 key slots and two stages;
  // up to 16 x 16: 256 slots and one stage (two do not fit)
  if (H <= 14 && Lq <= 200 && H + W <= Layout<14, 200>::kMaxF)
    return launch_variant<14, 200, 2>(q, k, v, sq, sk, sv, prm, BW, st);
  return launch_variant<16, 256, 1>(q, k, v, sq, sk, sv, prm, BW, st);
}

}  // namespace win_sm90
}  // namespace ivlm
