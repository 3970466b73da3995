// Flash attention forward for Hopper (sm_90a), bf16 in, bf16 out, f32 lse.
//
// Replaces the Pallas TPU kernel interactvlm_tpu/ops/flash_attention.py
// `_flash_kernel` (wrapper `_flash_forward`): online-softmax attention with
// optional bottom-right-aligned causal masking, per-batch-row kv lengths, and
// the per-row logsumexp that a backward pass reads.
//
// Three routes by head dim (ops/flash_attention.py:fwd_route):
// - 128 (the LLaMA-13B shapes and the padded SAM and window-probe grids):
//   the wgmma and TMA kernel of flash_fwd_sm90.cuh;
// - 16 (the SAM decoder's image->token attention and the fusion): the
//   wgmma and TMA kernel of flash_fwd_d16_sm90.cuh, which reads q, k and v
//   as the projections' strided views (ivlm_flash_fwd_d16 below);
// - 32 and 64: the mma.sync core below (no caller of the port's presets).
//
// What bounds the mma.sync core on the H100: at the shapes it takes the
// bytes. It reads Q once into registers and each K/V tile once per 64-row
// query tile, keeps the logits and probabilities in registers (never in
// device memory), skips the key tiles that the causal mask or kv length
// hides, and masks ragged edges in-kernel instead of padding keys and head
// dims to 128 as the TPU layout did.
#include "attention_core.cuh"
#include "flash_fwd_d16_sm90.cuh"
#include "flash_fwd_sm90.cuh"

using namespace ivlm;

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, const int* __restrict__ kv_lengths,
                     int heads, int Lq, int Lk, float scale, int causal) {
  __shared__ __align__(16) bf16 Ks[BK][D + 8];
  __shared__ __align__(16) bf16 Vs[BK][D + 8];
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int kv_len = kv_lengths != nullptr ? kv_lengths[bh / heads] : Lk;
  const size_t qoff = (size_t)bh * Lq * D;
  const size_t koff = (size_t)bh * Lk * D;
  attention_rows<D>(q + qoff, k + koff, v + koff, o + qoff,
                    lse + (size_t)bh * Lq, Lq, Lk, q0, kv_len, scale,
                    causal != 0, Lk - Lq, NoBias{}, Ks, Vs);
}

// D = 128, 32 or 64 (16 takes ivlm_flash_fwd_d16).
// q: (BH, Lq, D), k/v: (BH, Lk, D), o: (BH, Lq, D) bf16 contiguous;
// lse: (BH, Lq) f32; kv_lengths: (BH / heads,) int32 or null.
// Returns the launch status (0 = launched).
extern "C" int ivlm_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, const void* kv_lengths,
                              int bh, int heads, int lq, int lk, int d,
                              float scale, int causal, void* stream) {
  if (bh <= 0 || heads <= 0 || lq <= 0 || lk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(bh, (lq + BQ - 1) / BQ);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  float* lp = static_cast<float*>(lse);
  const int* kl = static_cast<const int*>(kv_lengths);
  if (d == flash_sm90::kD)
    return static_cast<int>(flash_sm90::launch(qp, kp, vp, op, lp, kl, bh,
                                               heads, lq, lk, scale, causal,
                                               st));
#define IVLM_LAUNCH(DIM)                                                      \
  case DIM:                                                                   \
    flash_fwd_kernel<DIM><<<grid, NTHREADS, 0, st>>>(qp, kp, vp, op, lp, kl,  \
                                                     heads, lq, lk, scale,    \
                                                     causal);                 \
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

// D = 16: q, k, v (B, H, L, 16) bf16 views with element strides
// (batch, head, row) sq, sk, sv, multiples of 8, unit stride on the head
// dim, 16-byte aligned; o: (B, Lq, H, 16) bf16 contiguous; lse: (B*H, Lq)
// f32; kv_lengths: (B,) int32 or null; key_width: the key tile
// (ops/flash_attention.py:d16_key_tiles); tiles_per_cta, heads_per_cta:
// the 128-row query tiles and the heads a CTA takes, 0 for the kernel's
// own plan. Returns the launch status.
extern "C" int ivlm_flash_fwd_d16(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* kv_lengths, long long sq0, long long sq1, long long sq2,
    long long sk0, long long sk1, long long sk2, long long sv0, long long sv1,
    long long sv2, int b, int h, int lq, int lk, float scale, int causal,
    int key_width, int tiles_per_cta, int heads_per_cta, void* stream) {
  const long long sq[3] = {sq0, sq1, sq2}, sk[3] = {sk0, sk1, sk2},
                  sv[3] = {sv0, sv1, sv2};
  return static_cast<int>(flash_d16::launch(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), sq, sk, sv, static_cast<bf16*>(o),
      static_cast<float*>(lse), static_cast<const int*>(kv_lengths), b, h, lq,
      lk, scale, causal, key_width, tiles_per_cta, heads_per_cta,
      static_cast<cudaStream_t>(stream)));
}

// The CTAs of the D = 16 kernel an SM holds at key width key_width, lk
// keys, h heads and heads_per_cta heads a CTA (0: its own choice), what its
// launch plan reads; or minus the error code.
extern "C" int ivlm_flash_fwd_d16_blocks_per_sm(int key_width, int lk, int h,
                                                int heads_per_cta) {
  int per_sm = 0;
  const cudaError_t err =
      flash_d16::blocks_per_sm(key_width, lk, h, heads_per_cta, &per_sm);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

IVLM_EXPORT_ERROR_STRING(ivlm_flash_attention)
