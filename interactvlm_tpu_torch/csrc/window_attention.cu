// SAM window attention with the decomposed relative-position bias, for
// Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas TPU kernel interactvlm_tpu/ops/sam_attention.py
// `_window_kernel` (wrapper `fused_window_attention`). Each (window, head)
// row attends over its L = H*W tokens with
//   bias[q, c] = f[c / W, q] + f[H + c % W, q],
// where f (R, H+W, L) stacks rel_h and rel_w, the two factor einsums that
// stay outside the kernel. The L x L bias is rebuilt from f in shared
// memory by index arithmetic and never exists in device memory.
//
// What bounds it on the H100: at ViT-H's 14x14 windows (L = 196, D = 80,
// R = 12 800 rows per block) a row does 4*L*L*D = 12.3 Mflop against
// 4*L*D*2 + 28*L*2 = 136 KB, about 90 flops/byte: the bound is bytes. The
// design reads every q/k/v/factor byte from device memory once per 64-row
// query tile at its natural shape (L = 196 and D = 80 masked at the tile
// edges in-kernel, no host padding, which was the cost the TPU design had to
// remove) and keeps logits and probabilities in registers: the 196 x 196 f32
// logits tile (154 KB) is never materialised, because the key loop runs the
// same online softmax as the flash kernel over 64-key tiles.
#include "attention_core.cuh"

using namespace ivlm;

namespace {

constexpr int MAXF = 64;  // largest H + W a window may have

struct WindowBias {
  static constexpr bool kActive = true;
  const bf16 (*f)[BQ];
  int H, W, q0;
  __device__ __forceinline__ float operator()(int r, int c) const {
    const int ql = r - q0;
    const int kh = c / W;
    const int kw = c - kh * W;
    return __bfloat162float(f[kh][ql]) + __bfloat162float(f[H + kw][ql]);
  }
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    window_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ factors,
                  bf16* __restrict__ o, int L, int H, int W, float scale) {
  __shared__ __align__(16) bf16 Ks[BK][D + 8];
  __shared__ __align__(16) bf16 Vs[BK][D + 8];
  __shared__ bf16 fs[MAXF][BQ];
  const int r = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int F = H + W;
  const bf16* fr = factors + (size_t)r * F * L;
  for (int i = threadIdx.x; i < F * BQ; i += NTHREADS) {
    const int j = i / BQ, ql = i % BQ, qq = q0 + ql;
    fs[j][ql] = qq < L ? fr[(size_t)j * L + qq] : __float2bfloat16(0.f);
  }
  __syncthreads();
  const size_t off = (size_t)r * L * D;
  attention_rows<D>(q + off, k + off, v + off, o + off, nullptr, L, L, q0, L,
                    scale, false, 0, WindowBias{fs, H, W, q0}, Ks, Vs);
}

}  // namespace

// q/k/v/o: (R, L, D) bf16 contiguous, L = H*W; factors: (R, H+W, L) bf16.
// Returns the launch status (0 = launched).
extern "C" int ivlm_window_attn(const void* q, const void* k, const void* v,
                                const void* factors, void* o, int rows, int L,
                                int H, int W, int d, float scale,
                                void* stream) {
  if (rows <= 0 || L != H * W || H + W > MAXF || L <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(rows, (L + BQ - 1) / BQ);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* fp = static_cast<const bf16*>(factors);
  bf16* op = static_cast<bf16*>(o);
#define IVLM_LAUNCH(DIM)                                                     \
  case DIM:                                                                  \
    window_kernel<DIM><<<grid, NTHREADS, 0, st>>>(qp, kp, vp, fp, op, L, H,  \
                                                  W, scale);                 \
    break;
  switch (d) {
    IVLM_LAUNCH(16)
    IVLM_LAUNCH(32)
    IVLM_LAUNCH(64)
    IVLM_LAUNCH(80)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef IVLM_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

IVLM_EXPORT_ERROR_STRING(ivlm_window_attention)
