// Flash attention forward for head dim 128 on Hopper's own machinery
// (sm_90a): wgmma products fed by TMA through an mbarrier ring. Launched by
// ivlm_flash_fwd (flash_attention.cu) for D = 128; the smaller head dims
// stay on the mma.sync core of attention_core.cuh.
//
// Replaces, at D = 128, the Pallas TPU kernel
// interactvlm_tpu/ops/flash_attention.py `_flash_kernel` (wrapper
// `_flash_forward`): the same online-softmax attention over (B*H, L, 128)
// bf16, bottom-right-aligned causal masking (offset Lk - Lq), per-batch-row
// kv lengths, and the f32 per-row logsumexp the backward kernels read. A
// row that sees no key writes o = 0 and lse = 0.
//
// What bounds it on the H100: the LLaMA-13B shapes (L = 319 to 512, causal)
// carry ~160 flops a byte, under the card's ~295 bf16 ridge, so bytes; the
// window probe's global grid (L = Lk = 4096, non-causal) ~1000 flops a
// byte, the tensor cores. The mma.sync core (64 rows a CTA, 64-key tiles
// staged by the threads with no overlap of load and compute) reaches 11 %
// of the bound there. Here:
// - a CTA takes 128 query rows: two consumer warpgroups of 64 rows each and
//   a producer warp whose warpgroup gives its registers to them
//   (setmaxnreg). Q arrives once by TMA; K and V tiles of 64 keys come by
//   TMA (128-byte swizzle, one full barrier each, one empty barrier a
//   stage) through a 4-deep ring, so the next tiles load during this one's
//   products;
// - S = Q K^T runs on wgmma m64n64k16 with both operands from shared
//   memory, K-major; the online softmax runs on the f32 accumulators in
//   registers;
// - P is rounded to bf16 in registers, where the accumulator fragment of
//   two neighbouring 8-key blocks is the A fragment of a 16-key step, and
//   O += P V runs on wgmma m64n128k16 with A from registers and V's tile as
//   an MN-major (transposed) B operand;
// - the arithmetic is the mma.sync core's, step for step (64-key tiles, the
//   same softmax expressions and summation order), so the outputs and the
//   logsumexp the backward kernels read are that core's bits;
// - key tiles the causal mask or the kv length hides entirely are never
//   loaded; only boundary tiles are masked; 3-D tensor maps (head dim,
//   rows, batch*head) zero-fill rows past Lq or Lk within a head, so ragged
//   lengths need no host padding; causal grids run their longest row
//   blocks first.
#pragma once

#include "attention_core.cuh"
#include "sm90_core.cuh"

namespace ivlm {
namespace flash_sm90 {

using namespace ivlm::sm90;

constexpr int kD = 128;
constexpr int kBQ = 128;      // query rows a CTA: two warpgroups of 64
constexpr int kBKeys = 64;    // keys a K or V tile
constexpr int kStages = 4;    // K/V tiles in flight
constexpr int kThreads = 384; // warpgroups 0, 1 consume; 2 produces
constexpr int kPanelCols = 64;               // head-dim columns a 128-byte row
constexpr int kQPanel = kBQ * 128;           // bytes of 64 columns of Q
constexpr int kKVPanel = kBKeys * 128;       // ... of a K or V tile
constexpr int kQBytes = 2 * kQPanel;
constexpr int kKVBytes = 2 * kKVPanel;
constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes +
                      8 * (1 + 3 * kStages);

struct Params {
  const int* kv_lengths;  // (B,) or null
  bf16* o;                // (BH, Lq, 128)
  float* lse;             // (BH, Lq)
  int heads, Lq, Lk;
  float scale;
  int causal;
};

__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;                        // 2 panels of 128 rows
  unsigned char* ks = smem + kQBytes;              // kStages tiles
  unsigned char* vs = ks + kStages * kKVBytes;     // kStages tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * kKVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int rb = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = rb * kBQ;
  const int offset = p.Lk - p.Lq;
  int kvl = p.Lk;
  if (p.kv_lengths != nullptr) kvl = min(kvl, p.kv_lengths[bh / p.heads]);
  int kend = kvl;  // keys past kend are hidden from every row of the CTA
  if (p.causal) kend = min(kend, q0 + kBQ + offset);
  const int ntiles = kend > 0 ? (kend + kBKeys - 1) / kBKeys : 0;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every TMA load
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256 && ntiles > 0) {
      mbar_arrive_expect_tx(q_full, kQBytes);
      for (int c = 0; c < 2; ++c)
        tma_load_3d(qs + c * kQPanel, &tq, q_full, c * kPanelCols, q0, bh);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < ntiles; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* kd = ks + stage * kKVBytes;
        unsigned char* vd = vs + stage * kKVBytes;
        mbar_arrive_expect_tx(&k_full[stage], kKVBytes);
        for (int c = 0; c < 2; ++c)
          tma_load_3d(kd + c * kKVPanel, &tk, &k_full[stage], c * kPanelCols,
                      kt * kBKeys, bh);
        mbar_arrive_expect_tx(&v_full[stage], kKVBytes);
        for (int c = 0; c < 2; ++c)
          tma_load_3d(vd + c * kKVPanel, &tv, &v_full[stage], c * kPanelCols,
                      kt * kBKeys, bh);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. q0 + 64 wg + 63
  setmaxnreg_inc<240>();
  const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wrow = q0 + wg * 64;
  const int r0 = wrow + warp * 16 + g, r1 = r0 + 8;
  float o[64], s[kBKeys / 2];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m0 = neg_inf(), m1 = neg_inf(), l0 = 0.f, l1 = 0.f;

  if (ntiles > 0) mbar_wait(q_full, 0);
  const uint32_t qa = smem_addr(qs) + wg * 64 * 128;
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < ntiles; ++kt) {
    const uint32_t ka = smem_addr(ks + stage * kKVBytes);
    const uint32_t va = smem_addr(vs + stage * kKVBytes);

    // S = Q K^T over the head dim: 8 steps of 16, 4 in each 64-column panel
    mbar_wait(&k_full[stage], phase);
    wgmma_fence();
    wgmma_bf16_ss_n64_set(s, desc_kmajor(qa), desc_kmajor(ka));
#pragma unroll
    for (int kk = 1; kk < kD / 16; ++kk)
      wgmma_bf16_ss_n64(
          s, desc_kmajor(qa + (kk / 4) * kQPanel + (kk % 4) * 32),
          desc_kmajor(ka + (kk / 4) * kKVPanel + (kk % 4) * 32), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // the mma.sync core's softmax, expression for expression: the logits
    // scaled (no fma), masked on boundary tiles, the running max, and
    // exp2f of (x - max) * log2 e
    const int kbase = kt * kBKeys;
    const bool edge = kbase + kBKeys > kvl ||
                      (p.causal && kbase + kBKeys - 1 > wrow + offset);
    float mx0 = neg_inf(), mx1 = neg_inf();
#pragma unroll
    for (int j = 0; j < kBKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[4 * j + e], p.scale);
        if (edge) {
          const int c = kbase + 8 * j + 2 * tig + (e & 1);
          const int r = e < 2 ? r0 : r1;
          if (c >= kvl || (p.causal && c > r + offset)) x = neg_inf();
        }
        s[4 * j + e] = x;
        if (e < 2) {
          mx0 = fmaxf(mx0, x);
        } else {
          mx1 = fmaxf(mx1, x);
        }
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with no visible key so far keeps max -inf: exponentiate against
    // 0 so every masked entry and the old state give exactly 0
    const float mu0 = mn0 == neg_inf() ? 0.f : mn0;
    const float mu1 = mn1 == neg_inf() ? 0.f : mn1;
    const float al0 = exp2f((m0 - mu0) * LOG2E);
    const float al1 = exp2f((m1 - mu1) * LOG2E);
    m0 = mn0;
    m1 = mn1;

    // P in f32 for the row sums (added in the core's order), in bf16 A
    // fragments for the product
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBKeys / 8; ++j) {
      s[4 * j + 0] = exp2f((s[4 * j + 0] - mu0) * LOG2E);
      s[4 * j + 1] = exp2f((s[4 * j + 1] - mu0) * LOG2E);
      s[4 * j + 2] = exp2f((s[4 * j + 2] - mu1) * LOG2E);
      s[4 * j + 3] = exp2f((s[4 * j + 3] - mu1) * LOG2E);
      rs0 += s[4 * j + 0];
      rs0 += s[4 * j + 1];
      rs1 += s[4 * j + 2];
      rs1 += s[4 * j + 3];
    }
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[4 * j + 0] *= al0;
      o[4 * j + 1] *= al0;
      o[4 * j + 2] *= al1;
      o[4 * j + 3] *= al1;
    }
    uint32_t pa[kBKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBKeys / 16; ++kk) {
      pa[kk][0] = pack_f32(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_f32(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_f32(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_f32(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O += P V: 4 steps of 16 keys; V's rows are keys (K), its 128-byte
    // panels head-dim columns (N)
    mbar_wait(&v_full[stage], phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBKeys / 16; ++kk)
      wgmma_bf16_rs_n128_tb(o, pa[kk],
                            desc_sw128(va + kk * 16 * 128, kKVPanel, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const size_t base = (size_t)bh * p.Lq;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int col = 8 * j + 2 * tig;
    if (r0 < p.Lq)
      *reinterpret_cast<uint32_t*>(p.o + (base + r0) * kD + col) =
          pack_f32(o[4 * j + 0] * inv0, o[4 * j + 1] * inv0);
    if (r1 < p.Lq)
      *reinterpret_cast<uint32_t*>(p.o + (base + r1) * kD + col) =
          pack_f32(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  if (tig == 0) {
    if (r0 < p.Lq) p.lse[base + r0] = l0 > 0.f ? m0 + logf(l0) : 0.f;
    if (r1 < p.Lq) p.lse[base + r1] = l1 > 0.f ? m1 + logf(l1) : 0.f;
  }
}

// q: (bh, lq, 128), k/v: (bh, lk, 128), o: (bh, lq, 128) bf16 contiguous,
// 16-byte aligned; lse: (bh, lq) f32; kv_lengths: (bh / heads,) int32 or
// null.
inline cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                          float* lse, const int* kv_lengths, int bh, int heads,
                          int lq, int lk, float scale, int causal,
                          cudaStream_t st) {
  if (bh > 65535) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  const cuuint64_t dq[3] = {kD, (cuuint64_t)lq, (cuuint64_t)bh};
  const cuuint64_t dk[3] = {kD, (cuuint64_t)lk, (cuuint64_t)bh};
  const cuuint64_t sq[2] = {kD * 2, (cuuint64_t)lq * kD * 2};
  const cuuint64_t sk[2] = {kD * 2, (cuuint64_t)lk * kD * 2};
  const cuuint32_t bq[3] = {kPanelCols, kBQ, 1};
  const cuuint32_t bk[3] = {kPanelCols, kBKeys, 1};
  const CUtensorMapDataType t = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode_sw128(&tq, t, 3, q, dq, sq, bq) ||
      !encode_sw128(&tk, t, 3, k, dk, sk, bk) ||
      !encode_sw128(&tv, t, 3, v, dk, sk, bk))
    return cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return attr;
  const Params prm{kv_lengths, o, lse, heads, lq, lk, scale, causal};
  const dim3 grid((lq + kBQ - 1) / kBQ, bh);
  flash_fwd_sm90_kernel<<<grid, kThreads, kSmem, st>>>(tq, tk, tv, prm);
  return cudaGetLastError();
}

}  // namespace flash_sm90
}  // namespace ivlm
