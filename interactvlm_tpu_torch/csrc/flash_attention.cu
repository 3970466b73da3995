// Flash attention forward for Hopper (sm_90a), bf16 in, bf16 out, f32 lse.
//
// Replaces the Pallas TPU kernel interactvlm_tpu/ops/flash_attention.py
// `_flash_kernel` (wrapper `_flash_forward`): online-softmax attention with
// optional bottom-right-aligned causal masking, per-batch-row kv lengths, and
// the per-row logsumexp that a backward pass reads.
//
// What bounds it on the H100: at the LLaMA-13B prefill shape (B*H = 320,
// L = 319, D = 128) the work is 4*L*L*D flops per row against 4*L*D*2 bytes,
// about 160 flops/byte, under the card's ~295 bf16 flops/byte ridge, so the
// bound is the bytes; at the SAM decoder's image->token shape (Lk = 9,
// D = 16) it is bytes by far. The design therefore reads Q once into
// registers and each K/V tile once per 64-row query tile, keeps the logits
// and probabilities in registers (never in device memory), skips the key
// tiles that the causal mask or kv length hides, and masks the ragged
// Lk = 9 edge in-kernel instead of padding keys and head dims to 128 as the
// TPU layout did. Head dim 128 (the LLaMA-13B shapes and the window probe's
// padded global grid) takes the wgmma and TMA kernel of flash_fwd_sm90.cuh
// instead; 16, 32 and 64 stay on this mma.sync core.
#include "attention_core.cuh"
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
    IVLM_LAUNCH(16)
    IVLM_LAUNCH(32)
    IVLM_LAUNCH(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef IVLM_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

IVLM_EXPORT_ERROR_STRING(ivlm_flash_attention)
