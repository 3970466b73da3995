// The bf16 serving matmul for Hopper (sm_90a): x (M, K) bf16 times W (N, K)
// bf16 with f32 accumulation on the tensor cores, then an optional f32 bias
// and an optional GELU in the epilogue, written as bf16 or f32.
//
// Replaces the Pallas TPU kernels of interactvlm_tpu/ops/serving_matmul.py
// `_kernel`, `_kernel_nobias`, `_kernel_ksplit` and `_kernel_ksplit_nobias`
// (wrapper `fused_dense`): out = act(f32(x @ W^T) + bias), the GELU exact
// (erff; the TPU kernel's Abramowitz-Stegun polynomial is within 1.5e-7 of
// erf) or tanh. The four Pallas bodies differ only in the bias, and in
// splitting K over grid steps, which existed because Mosaic failed to
// compile single K = 5120 blocks; here one kernel loops over K in any case,
// and the bias and the activation are arguments.
//
// What bounds it on the H100: at the chain probe's shapes (M = 32 768,
// K x N = 1280 x 5120 and 5120 x 1280) it does 2 M K N flops against
// 2 (M K + K N + M N) bytes, ~1000 flops a byte, above the card's ~295
// bf16 flops a byte: the bf16 tensor cores. The TPU kernel kept a column
// block of the weight resident in VMEM across the row sweep. Here blocks
// own 128 x 128 output tiles and run in parallel (the column tiles of one
// row block run next to each other, so x is read from device memory about
// once, and the whole weight stays in the 50 MB L2); both operands stream
// through a 4-deep cp.async ring of 32-wide K chunks in dynamic shared
// memory, 8 warps each own a 64 x 32 accumulator tile in registers, and the
// products run on mma.sync m16n8k16 with fragments from ldmatrix. This is
// the simple design: wgmma and TMA, which the card needs for its full rate,
// are later work.
#include "matmul_core.cuh"

namespace {

using namespace ivlm;

struct Epilogue {
  const float* bias;  // null: no bias
  void* out;
  int out_f32;
  int act;
};

// 128 x 128 output tiles, 8 warps of 64 x 32, a 4-deep ring of 32-wide K
// chunks (80 KB of dynamic shared memory: two blocks fit on an SM)
using Dense = Tile<bf16, 128, 128, 32, 2, 4, 4>;

template <class TL>
__global__ void __launch_bounds__(TL::kThreads)
    dense_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 Epilogue ep, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * TL::BN, m0 = blockIdx.y * TL::BM;
  float acc[TL::MT][TL::NT][4];
  mainloop<TL>(acc, x, w, smem, m0, n0, M, N, K);
  // the bias is added in f32, then the activation
  const bool has_bias = ep.bias != nullptr;
  auto col = [&](int n) {
    return has_bias ? make_float2(ep.bias[n], ep.bias[n + 1])
                    : make_float2(0.f, 0.f);
  };
  for_each_pair<TL>(acc, m0, n0, M, N, col,
                    [&](const float2& b, int m, int n, float v0, float v1) {
    if (has_bias) {
      v0 = __fadd_rn(v0, b.x);
      v1 = __fadd_rn(v1, b.y);
    }
    store2(ep.out, (size_t)m * N + n, ep.out_f32, apply_act(v0, ep.act),
           apply_act(v1, ep.act));
  });
}

}  // namespace

// x: (M, K) bf16; w: (N, K) bf16; bias: (N,) f32 or null; out: (M, N) bf16
// (out_f32 = 0) or f32; act: 0 none, 1 exact GELU, 2 tanh GELU. Every
// pointer contiguous and 16-byte aligned, K % 8 == 0, N % 8 == 0. Returns
// the launch status (0 = launched).
extern "C" int ivlm_fused_dense(const void* x, const void* w, const void* bias,
                                void* out, int out_f32, int act, int M, int N,
                                int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 8 != 0 || act < 0 ||
      act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_blocks = (M + Dense::BM - 1) / Dense::BM;
  if (row_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB of shared memory only once the limit is raised (per device)
  const cudaError_t e = cudaFuncSetAttribute(
      dense_kernel<Dense>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Dense::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Epilogue ep{static_cast<const float*>(bias), out, out_f32, act};
  const dim3 grid((N + Dense::BN - 1) / Dense::BN, row_blocks);
  dense_kernel<Dense>
      <<<grid, Dense::kThreads, Dense::kSmem,
         static_cast<cudaStream_t>(stream)>>>(static_cast<const bf16*>(x),
                                              static_cast<const bf16*>(w), ep,
                                              M, N, K);
  return static_cast<int>(cudaGetLastError());
}

IVLM_EXPORT_ERROR_STRING(ivlm_serving_matmul)
