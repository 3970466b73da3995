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
// compile single K = 5120 blocks; here one kernel loops over K in any case.
//
// What bounds it on the H100: at the chain probe's shapes (M = 32 768,
// K x N = 1280 x 5120 and 5120 x 1280) it does 2 M K N flops against
// 2 (M K + K N + M N) bytes, ~1000 flops a byte, above the card's ~295
// bf16 flops a byte: the bf16 tensor cores, whose full rate only wgmma
// reaches. So it runs on the GEMM skeleton of gemm_sm90.cuh, as the int8
// GEMM does: persistent CTAs walking 128 x 256 tiles, a TMA ring of
// 128-byte-swizzled K chunks of 64 bf16 values (x and W both K-major: W is
// (N, K), so no transpose), two consumer warpgroups on wgmma
// m64n256k16.f32.bf16.bf16 with 128 f32 accumulators a thread, and an
// epilogue compiled per bias, activation and output type that adds the bias
// in f32 (__fadd_rn), applies the GELU and stores whole 16-byte pieces
// through a per-warp shared buffer. (The port's first kernel, mma.sync fed
// by cp.async in 128 x 128 tiles, took 1.642 and 1.518 ms at the chain's
// shapes; PERF.md.)
#include "gemm_sm90.cuh"
#include "matmul_core.cuh"

namespace {

using namespace ivlm;
using namespace ivlm::gemm;

// bias in f32, then the activation, on a warp's accumulators in place
template <int ACT, bool BIAS, bool OUT_F32>
struct BiasAct {
  static constexpr bool kOutF32 = OUT_F32;
  const float* bias;  // (N,) or null
  void* out;          // (M, N) bf16 or f32

  __device__ __forceinline__ void apply(float (&acc)[kBN / 2], int, int n0,
                                        int, int N) const {
    const int tig = threadIdx.x & 3;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      float2 bv = make_float2(0.f, 0.f);
      if constexpr (BIAS) {
        const int n = min(n0 + j * 8 + tig * 2, N - 2);  // loads stay inside
        bv = *reinterpret_cast<const float2*>(bias + n);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = acc[4 * j + e];
        if constexpr (BIAS) v = __fadd_rn(v, (e & 1) ? bv.y : bv.x);
        acc[4 * j + e] = apply_act(v, ACT);
      }
    }
  }
};

template <int ACT, bool BIAS, bool OUT_F32>
__global__ void __launch_bounds__(kThreads, 1)
    dense_gemm_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tw,
                      BiasAct<ACT, BIAS, OUT_F32> ep, int M, int N, int K,
                      int tiles_m, int tiles_n) {
  gemm_body<Bf16>(tx, tw, ep, M, N, K, tiles_m, tiles_n);
}

template <int ACT, bool BIAS, bool OUT_F32>
cudaError_t launch_variant(const void* x, const void* w, const void* bias,
                           void* out, int M, int N, int K, cudaStream_t st) {
  const BiasAct<ACT, BIAS, OUT_F32> ep{static_cast<const float*>(bias), out};
  return launch<Bf16>(dense_gemm_kernel<ACT, BIAS, OUT_F32>, x, w, ep, M, N,
                      K, st);
}

template <int ACT>
cudaError_t launch_act(const void* x, const void* w, const void* bias,
                       void* out, int out_f32, int M, int N, int K,
                       cudaStream_t st) {
  if (out_f32)
    return bias ? launch_variant<ACT, true, true>(x, w, bias, out, M, N, K, st)
                : launch_variant<ACT, false, true>(x, w, bias, out, M, N, K, st);
  return bias ? launch_variant<ACT, true, false>(x, w, bias, out, M, N, K, st)
              : launch_variant<ACT, false, false>(x, w, bias, out, M, N, K, st);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (act == kGelu)
    err = launch_act<kGelu>(x, w, bias, out, out_f32, M, N, K, st);
  else if (act == kGeluTanh)
    err = launch_act<kGeluTanh>(x, w, bias, out, out_f32, M, N, K, st);
  else
    err = launch_act<kNone>(x, w, bias, out, out_f32, M, N, K, st);
  return static_cast<int>(err);
}

IVLM_EXPORT_ERROR_STRING(ivlm_serving_matmul)
