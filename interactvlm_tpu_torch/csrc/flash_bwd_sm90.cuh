// Flash attention backward for head dim 128 on Hopper's own machinery
// (sm_90a): two kernels, dQ (with D = rowsum(dO * O)) and dK/dV, wgmma
// products fed by TMA through an mbarrier ring. Launched by
// ivlm_flash_bwd_dq and ivlm_flash_bwd_dkv (flash_attention_bwd.cu) for
// D = 128, the "sm90" route of ops/flash_attention.py:bwd_route; 16, 32 and
// 64 stay on the mma.sync kernels there.
//
// Replaces, at D = 128, the Pallas TPU kernels
// interactvlm_tpu/ops/flash_attention.py `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (wrapper `_flash_backward`), and the torch D = rowsum
// that the wrapper took outside them: the same recompute formula
//   P = exp(S * scale - lse) on the visible keys, dP = dO V^T,
//   dS = P * (dP - D), dQ = scale * dS K, dK = scale * dS^T Q, dV = P^T dO,
// with P and dS rounded to bf16 as the products' operands, as the plain
// version (ops/flash_attention.py:flash_backward_plain) rounds them.
//
// What bounds them on the H100: at the LLaMA-13B training shape (B*H = 320,
// L = 512, causal) the dq kernel does 6 D flops a visible (query, key) pair
// and the dk/dv kernel 8 over ~250 MB each: about 150-200 flops a byte,
// under the card's ~295 bf16 ridge, so the bytes, narrowly; the products
// and the exps must therefore overlap the loads. The design:
// - dq: a CTA owns 128 query rows of one (batch*head): two consumer
//   warpgroups of 64 rows each and a producer warp. TMA brings the block's
//   Q and dO once; K and V tiles of 64 keys come through a 4-deep ring
//   (one full and one empty barrier a stage), only the tiles that the
//   causal limit and kv_len leave visible. Each consumer forms D for its
//   rows from O (read once from device memory) and the dO already in
//   shared memory, writes it to the (B*H, Lq) buffer the dk/dv kernel
//   reads, and keeps it in registers for its own dS. S = Q K^T and
//   dP = dO V^T run on wgmma m64n64k16 from shared memory (both K-major);
//   P and dS are formed in f32 on the accumulators and rounded to bf16 in
//   registers, where the accumulator fragment of two neighbouring 8-key
//   blocks is the A fragment of a 16-key step; dQ += dS K runs on wgmma
//   m64n128k16 with A from registers and the K tile as an MN-major B.
// - dk/dv: a CTA owns 64 keys and the producer warp streams tiles of 64
//   queries (Q, dO, and their lse and D rows, which the producer warp
//   stages itself) through the ring, from the first tile that the causal
//   offset lets see the CTA's keys; K and V arrive once. One consumer
//   warpgroup runs S^T = K Q^T, forms P^T and accumulates dV += P^T dO;
//   the other runs dP^T = V dO^T, takes P^T (f32) from the first through
//   shared memory, forms dS^T and accumulates dK += dS^T Q. So P^T and dS^T
//   land in registers in the A-fragment layout of their products, which
//   take dO and Q as MN-major B; each warpgroup holds one 64 x 128 f32
//   accumulator (64 registers a thread) and one 64 x 64 product, and the
//   tile costs the four products it needs. (ptxas gives a block of 384
//   threads 168 registers a thread, whatever setmaxnreg later grants; one
//   warpgroup holding dK and dV for its 64 keys besides S^T and dP^T
//   spilled and had its wgmma serialized.) No atomics: the gradients are
//   deterministic. A CTA whose keys all lie at or past kv_len writes zeros
//   and loads nothing.
// - 3-D tensor maps (head dim, rows, batch*head) zero-fill rows past Lq or
//   Lk within a head: a zero Q and dO row with lse = D = 0 gives P = 1 and
//   dS = 0 against zero operands, so it adds nothing and needs no mask;
//   masks (kv_len and causal) are applied only on the tiles they cut.
#pragma once

#include "attention_core.cuh"
#include "sm90_core.cuh"

namespace ivlm {
namespace flash_bwd_sm90 {

using namespace ivlm::sm90;

constexpr int kD = 128;
constexpr int kBlock = 128;   // query rows a dq CTA owns
constexpr int kTile = 64;     // rows a streamed tile: keys (dq), queries
constexpr int kStages = 4;    // tiles in flight
constexpr int kThreads = 384; // warpgroups 0, 1 consume; warp 8 produces
constexpr int kKeys = 64;     // keys a dk/dv CTA owns
constexpr int kPanelCols = 64;               // head-dim columns a 128-byte row
constexpr int kBlockPanel = kBlock * 128;    // bytes of 64 columns of a block
constexpr int kTilePanel = kTile * 128;      // ... of a tile
constexpr int kBlockBytes = 2 * kBlockPanel;
constexpr int kTileBytes = 2 * kTilePanel;  // also a dk/dv CTA's K or V
constexpr int kStageBytes = 2 * kTileBytes;  // K and V (dq); Q and dO (dk/dv)
constexpr int kRowFloats = 2 * kTile;        // a dk/dv stage's lse and D rows
constexpr int kBarBytes = 8 * (1 + 2 * kStages);
constexpr int kDqSmem = 1024 + 2 * kBlockBytes + kStages * kStageBytes +
                        kBarBytes;
constexpr int kPBufVecs = 8 * 128;           // a P^T buffer: 8 float4 a thread
constexpr int kDkvSmem = 1024 + 2 * kTileBytes + kStages * kStageBytes +
                         2 * kPBufVecs * 16 + kStages * kRowFloats * 4 +
                         kBarBytes;
constexpr int kBarPFull = 1, kBarPEmpty = 3;  // named barriers, 2 each

struct DqParams {
  const bf16* o;          // (BH, Lq, 128)
  const float* lse;       // (BH, Lq)
  float* dsum;            // (BH, Lq), written
  bf16* dq;               // (BH, Lq, 128), written
  const int* kv_lengths;  // (B,) or null
  int heads, Lq, Lk;
  float scale;
  int causal;
};

struct DkvParams {
  const float* lse;       // (BH, Lq)
  const float* dsum;      // (BH, Lq), from the dq kernel
  bf16* dk;               // (BH, Lk, 128), written
  bf16* dv;
  const int* kv_lengths;
  int heads, Lq, Lk;
  float scale;
  int causal;
};

// The 16-byte chunk `c` (of 16) of row `r` of a 128-row-or-fewer block
// held as two 64-column panels of `panel` bytes, 128-byte swizzled as TMA
// writes it.
__device__ __forceinline__ uint4 ld_swizzled(const unsigned char* base,
                                             int panel, int r, int c) {
  return *reinterpret_cast<const uint4*>(
      base + (c >> 3) * panel + r * 128 + ((((c & 7) ^ r) & 7) << 4));
}

// S (+)= A B^T over the head dim, m64n64: A's 64 rows at `a` in a block
// whose panels are `a_panel` bytes apart, B's 64 rows at `b` (panels
// `b_panel` apart), both K-major; 8 steps of 16, 4 in each panel.
__device__ __forceinline__ void product_n64(float (&d)[32], uint32_t a,
                                            int a_panel, uint32_t b,
                                            int b_panel) {
  wgmma_bf16_ss_n64_set(d, desc_kmajor(a), desc_kmajor(b));
#pragma unroll
  for (int kk = 1; kk < kD / 16; ++kk)
    wgmma_bf16_ss_n64(d, desc_kmajor(a + (kk / 4) * a_panel + (kk % 4) * 32),
                      desc_kmajor(b + (kk / 4) * b_panel + (kk % 4) * 32), 1);
}

// acc += A B, m64n128k64: A the bf16 fragments of a 64 x 64 accumulator
// (4 steps of 16 along its columns), B the 64 x 128 tile at `b`, rows along
// K, two 64-column panels `kTilePanel` apart (MN-major).
__device__ __forceinline__ void product_rs(float (&acc)[64],
                                           const uint32_t (&a)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
    wgmma_bf16_rs_n128_tb(acc, a[kk],
                          desc_sw128(b + kk * 16 * 128, kTilePanel, 1024), 1);
}

// The bf16 A fragments of a 64 x 64 f32 accumulator: two neighbouring
// 8-column blocks are one 16-wide step.
__device__ __forceinline__ void pack_fragments(const float (&x)[32],
                                               uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_f32(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_f32(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_f32(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_f32(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// Stores a 64 x 128 f32 accumulator times `mul` as bf16 rows r0 and r0 + 8
// (local to the warp's fragment) of `out`, rows past `rows` dropped.
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[64],
                                           float mul, int r0, int rows,
                                           int tig) {
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int col = 8 * j + 2 * tig;
    if (r0 < rows)
      *reinterpret_cast<uint32_t*>(out + (size_t)r0 * kD + col) =
          pack_f32(acc[4 * j + 0] * mul, acc[4 * j + 1] * mul);
    if (r0 + 8 < rows)
      *reinterpret_cast<uint32_t*>(out + (size_t)(r0 + 8) * kD + col) =
          pack_f32(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

__device__ __forceinline__ void init_barriers(uint64_t* once, uint64_t* full,
                                              uint64_t* empty,
                                              uint32_t full_count) {
  if (threadIdx.x == 0) {
    mbar_init(once, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], full_count);
      mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             DqParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;                   // Q block, 2 panels
  unsigned char* dos = qs + kBlockBytes;      // dO block
  unsigned char* ring = dos + kBlockBytes;    // a stage: K tile, V tile
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* full = qd_full + 1;
  uint64_t* empty = full + kStages;

  // causal grids run their longest row blocks first
  const int rb = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = rb * kBlock;
  const int offset = p.Lk - p.Lq;
  int kvl = p.Lk;
  if (p.kv_lengths != nullptr) kvl = min(kvl, p.kv_lengths[bh / p.heads]);
  int kend = kvl;  // keys past kend are hidden from every row of the CTA
  if (p.causal) kend = min(kend, q0 + kBlock + offset);
  const int ntiles = kend > 0 ? (kend + kTile - 1) / kTile : 0;
  const int wg = threadIdx.x / 128;
  init_barriers(qd_full, full, empty, 1);

  if (wg == 2) {
    // ---- producer: one thread issues every TMA load; Q and dO always
    // come (D is written for every row)
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(qd_full, 2 * kBlockBytes);
      for (int c = 0; c < 2; ++c) {
        tma_load_3d(qs + c * kBlockPanel, &tq, qd_full, c * kPanelCols, q0, bh);
        tma_load_3d(dos + c * kBlockPanel, &tdo, qd_full, c * kPanelCols, q0,
                    bh);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < ntiles; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* kd = ring + stage * kStageBytes;
        mbar_arrive_expect_tx(&full[stage], kStageBytes);
        for (int c = 0; c < 2; ++c) {
          tma_load_3d(kd + c * kTilePanel, &tk, &full[stage], c * kPanelCols,
                      kt * kTile, bh);
          tma_load_3d(kd + kTileBytes + c * kTilePanel, &tv, &full[stage],
                      c * kPanelCols, kt * kTile, bh);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. q0 + 64 wg + 63
  const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wrow = q0 + wg * 64;
  const int lr0 = wg * 64 + warp * 16 + g;  // row in the block
  const int r0 = q0 + lr0, r1 = r0 + 8;
  const size_t rows = (size_t)bh * p.Lq;
  const float l0 = r0 < p.Lq ? p.lse[rows + r0] : 0.f;
  const float l1 = r1 < p.Lq ? p.lse[rows + r1] : 0.f;

  // D = rowsum(dO * O) in f32: each thread of a quad takes the 16-byte
  // chunks tig, tig + 4, tig + 8, tig + 12 of the quad's two rows
  const bf16* ob = p.o + rows * kD;
  float d0 = 0.f, d1 = 0.f;
  mbar_wait(qd_full, 0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = tig + 4 * i;
    if (r0 < p.Lq)
      d0 = dot8(*reinterpret_cast<const uint4*>(ob + (size_t)r0 * kD + 8 * c),
                ld_swizzled(dos, kBlockPanel, lr0, c), d0);
    if (r1 < p.Lq)
      d1 = dot8(*reinterpret_cast<const uint4*>(ob + (size_t)r1 * kD + 8 * c),
                ld_swizzled(dos, kBlockPanel, lr0 + 8, c), d1);
  }
  d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
  d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
  if (tig == 0) {
    if (r0 < p.Lq) p.dsum[rows + r0] = d0;
    if (r1 < p.Lq) p.dsum[rows + r1] = d1;
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const uint32_t qa = smem_addr(qs) + wg * 64 * 128;
  const uint32_t da = smem_addr(dos) + wg * 64 * 128;
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int kbase = kt * kTile;
    mbar_wait(&full[stage], phase);
    // a tile past this warpgroup's causal limit (the other one sees it)
    if (!(p.causal && kbase > wrow + 63 + offset)) {
      const uint32_t ka = smem_addr(ring + stage * kStageBytes);
      const uint32_t va = ka + kTileBytes;
      float s[32], dp[32];
      wgmma_fence();
      product_n64(s, qa, kBlockPanel, ka, kTilePanel);
      wgmma_commit();
      product_n64(dp, da, kBlockPanel, va, kTilePanel);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      // P = exp(S * scale - lse), masked only on a tile the mask cuts
      const bool edge = kbase + kTile > kvl ||
                        (p.causal && kbase + kTile - 1 > wrow + offset);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = exp2f((s[4 * j + e] * p.scale - (e < 2 ? l0 : l1)) * LOG2E);
          if (edge) {
            const int c = kbase + 8 * j + 2 * tig + (e & 1);
            const int r = e < 2 ? r0 : r1;
            if (c >= kvl || (p.causal && c > r + offset)) x = 0.f;
          }
          s[4 * j + e] = x;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
      // dS = P * (dP - D), into dp
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dp[i] = s[i] * (dp[i] - ((i & 2) ? d1 : d0));
      uint32_t sa[4][4];
      pack_fragments(dp, sa);
      // dQ += dS K: the K tile's rows are keys (K), its panels columns (N)
      wgmma_fence();
      product_rs(acc, sa, ka);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  store_rows(p.dq + rows * kD, acc, p.scale, r0, p.Lq, tig);
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              DkvParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ks = smem;                    // K block, 2 panels
  unsigned char* vs = ks + kTileBytes;          // V block
  unsigned char* ring = vs + kTileBytes;        // a stage: Q tile, dO tile
  float4* pbuf = reinterpret_cast<float4*>(ring + kStages * kStageBytes);
  float* row_ring = reinterpret_cast<float*>(pbuf + 2 * kPBufVecs);
  uint64_t* kv_full =
      reinterpret_cast<uint64_t*>(row_ring + kStages * kRowFloats);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int k0 = blockIdx.x * kKeys;
  const int bh = blockIdx.y;
  const int offset = p.Lk - p.Lq;
  int kvl = p.Lk;
  if (p.kv_lengths != nullptr) kvl = min(kvl, p.kv_lengths[bh / p.heads]);
  // the first query that can see key k0 is k0 - offset under causal; a CTA
  // whose keys all lie past kv_len sees none. Every tile from qt0 on shows
  // some query a key of the CTA.
  const int qt0 = p.causal ? max(0, k0 - offset) / kTile : 0;
  const int nqt = k0 < kvl ? (p.Lq + kTile - 1) / kTile : 0;
  const int ntiles = max(0, nqt - qt0);
  const int wg = threadIdx.x / 128;
  // a stage completes on the 32 arrivals of the producer warp (one with
  // the TMA bytes) after each lane has staged its lse and D values
  init_barriers(kv_full, full, empty, 32);
  const size_t rows = (size_t)bh * p.Lq;

  if (wg == 2) {
    if (threadIdx.x < 288 && ntiles > 0) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * kTileBytes);
        for (int c = 0; c < 2; ++c) {
          tma_load_3d(ks + c * kTilePanel, &tk, kv_full, c * kPanelCols, k0,
                      bh);
          tma_load_3d(vs + c * kTilePanel, &tv, kv_full, c * kPanelCols, k0,
                      bh);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int qt = qt0; qt < nqt; ++qt) {
        const int qbase = qt * kTile;
        mbar_wait(&empty[stage], phase ^ 1);
        float* rw = row_ring + stage * kRowFloats;
#pragma unroll
        for (int h = 0; h < kTile / 32; ++h) {
          const int r = qbase + 32 * h + lane;
          rw[32 * h + lane] = r < p.Lq ? p.lse[rows + r] : 0.f;
          rw[kTile + 32 * h + lane] = r < p.Lq ? p.dsum[rows + r] : 0.f;
        }
        if (lane == 0) {
          unsigned char* qd = ring + stage * kStageBytes;
          mbar_arrive_expect_tx(&full[stage], kStageBytes);
          for (int c = 0; c < 2; ++c) {
            tma_load_3d(qd + c * kTilePanel, &tq, &full[stage],
                        c * kPanelCols, qbase, bh);
            tma_load_3d(qd + kTileBytes + c * kTilePanel, &tdo, &full[stage],
                        c * kPanelCols, qbase, bh);
          }
        } else {
          mbar_arrive(&full[stage]);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers, both on keys k0 .. k0 + 63: warpgroup 0 forms P^T and
  // dV, warpgroup 1 dP^T, dS^T and dK. Thread i of one holds the same
  // (key, query) elements as thread i of the other, so P^T passes between
  // them through shared memory as 8 float4 a thread, element-major (no
  // bank conflicts), in two buffers ordered by named barriers.
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int j0 = k0 + warp * 16 + g, j1 = j0 + 8;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const uint32_t ka = smem_addr(wg == 0 ? ks : vs);  // S^T's K, dP^T's V
  if (ntiles > 0) mbar_wait(kv_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < ntiles; ++i) {
    const int qbase = (qt0 + i) * kTile;
    const int buf = i & 1;
    float4* pb = pbuf + buf * kPBufVecs + tid;
    mbar_wait(&full[stage], phase);
    const uint32_t qa = smem_addr(ring + stage * kStageBytes);
    const uint32_t da = qa + kTileBytes;
    const float* lr = row_ring + stage * kRowFloats;
    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1)
    float s[32];
    wgmma_fence();
    product_n64(s, ka, kTilePanel, wg == 0 ? qa : da, kTilePanel);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    uint32_t frag[4][4];
    if (wg == 0) {
      // P^T = exp(S^T * scale - lse), rows keys, columns queries
      const bool edge = k0 + kKeys - 1 >= kvl ||
                        (p.causal && k0 + kKeys - 1 > qbase + offset);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const int col = 8 * j + 2 * tig;
        const float2 li = *reinterpret_cast<const float2*>(lr + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = exp2f((s[4 * j + e] * p.scale - ((e & 1) ? li.y : li.x)) *
                          LOG2E);
          if (edge) {
            const int key = e < 2 ? j0 : j1;
            const int r = qbase + col + (e & 1);
            if (key >= kvl || (p.causal && key > r + offset)) x = 0.f;
          }
          s[4 * j + e] = x;
        }
      }
      if (i >= 2) bar_sync(kBarPEmpty + buf, 256);  // read at tile i - 2
#pragma unroll
      for (int v = 0; v < 8; ++v)
        pb[v * 128] = make_float4(s[4 * v], s[4 * v + 1], s[4 * v + 2],
                                  s[4 * v + 3]);
      bar_arrive(kBarPFull + buf, 256);
    } else {
      // dS^T = P^T * (dP^T - D)
      bar_sync(kBarPFull + buf, 256);
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const float4 pv = pb[v * 128];
        const float2 di = *reinterpret_cast<const float2*>(
            lr + kTile + 8 * v + 2 * tig);
        s[4 * v + 0] = pv.x * (s[4 * v + 0] - di.x);
        s[4 * v + 1] = pv.y * (s[4 * v + 1] - di.y);
        s[4 * v + 2] = pv.z * (s[4 * v + 2] - di.x);
        s[4 * v + 3] = pv.w * (s[4 * v + 3] - di.y);
      }
      if (i + 2 < ntiles) bar_arrive(kBarPEmpty + buf, 256);
    }
    pack_fragments(s, frag);
    // dV += P^T dO or dK += dS^T Q: the tiles' rows are queries (K)
    wgmma_fence();
    product_rs(acc, frag, wg == 0 ? da : qa);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (tid == 0) mbar_arrive(&empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  const size_t keys = (size_t)bh * p.Lk;
  if (wg == 0)
    store_rows(p.dv + keys * kD, acc, 1.f, j0, p.Lk, tig);
  else
    store_rows(p.dk + keys * kD, acc, p.scale, j0, p.Lk, tig);
}

// The four tensor maps of a launch: q and dO boxes of `qrows` rows, k and v
// of `krows`, 64 columns (128 bytes) wide.
inline bool encode_maps(CUtensorMap (&m)[4], const bf16* q, const bf16* dO,
                        const bf16* k, const bf16* v, int bh, int lq, int lk,
                        int qrows, int krows) {
  const cuuint64_t dq[3] = {kD, (cuuint64_t)lq, (cuuint64_t)bh};
  const cuuint64_t dk[3] = {kD, (cuuint64_t)lk, (cuuint64_t)bh};
  const cuuint64_t sq[2] = {kD * 2, (cuuint64_t)lq * kD * 2};
  const cuuint64_t sk[2] = {kD * 2, (cuuint64_t)lk * kD * 2};
  const cuuint32_t bq[3] = {kPanelCols, (cuuint32_t)qrows, 1};
  const cuuint32_t bk[3] = {kPanelCols, (cuuint32_t)krows, 1};
  const CUtensorMapDataType t = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode_sw128(&m[0], t, 3, q, dq, sq, bq) &&
         encode_sw128(&m[1], t, 3, dO, dq, sq, bq) &&
         encode_sw128(&m[2], t, 3, k, dk, sk, bk) &&
         encode_sw128(&m[3], t, 3, v, dk, sk, bk);
}

// q, dO, o: (bh, lq, 128); k, v: (bh, lk, 128) bf16 contiguous, 16-byte
// aligned; lse: (bh, lq) f32; writes dsum (bh, lq) f32 and dq (bh, lq,
// 128) bf16; kv_lengths: (bh / heads,) int32 or null.
inline cudaError_t launch_dq(const bf16* q, const bf16* k, const bf16* v,
                             const bf16* dO, const bf16* o, const float* lse,
                             float* dsum, bf16* dq, const int* kv_lengths,
                             int bh, int heads, int lq, int lk, float scale,
                             int causal, cudaStream_t st) {
  if (bh > 65535) return cudaErrorInvalidValue;
  CUtensorMap m[4];
  if (!encode_maps(m, q, dO, k, v, bh, lq, lk, kBlock, kTile))
    return cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDqSmem);
  if (attr != cudaSuccess) return attr;
  const DqParams prm{o, lse, dsum, dq, kv_lengths, heads, lq, lk, scale,
                     causal};
  const dim3 grid((lq + kBlock - 1) / kBlock, bh);
  flash_bwd_dq_sm90_kernel<<<grid, kThreads, kDqSmem, st>>>(m[0], m[1], m[2],
                                                            m[3], prm);
  return cudaGetLastError();
}

// As launch_dq, reading dsum and writing dk, dv: (bh, lk, 128) bf16.
inline cudaError_t launch_dkv(const bf16* q, const bf16* k, const bf16* v,
                              const bf16* dO, const float* lse,
                              const float* dsum, bf16* dk, bf16* dv,
                              const int* kv_lengths, int bh, int heads, int lq,
                              int lk, float scale, int causal,
                              cudaStream_t st) {
  if (bh > 65535) return cudaErrorInvalidValue;
  CUtensorMap m[4];
  if (!encode_maps(m, q, dO, k, v, bh, lq, lk, kTile, kKeys))
    return cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDkvSmem);
  if (attr != cudaSuccess) return attr;
  const DkvParams prm{lse, dsum, dk, dv, kv_lengths, heads, lq, lk, scale,
                      causal};
  const dim3 grid((lk + kKeys - 1) / kKeys, bh);
  flash_bwd_dkv_sm90_kernel<<<grid, kThreads, kDkvSmem, st>>>(
      m[0], m[1], m[2], m[3], prm);
  return cudaGetLastError();
}

}  // namespace flash_bwd_sm90
}  // namespace ivlm
