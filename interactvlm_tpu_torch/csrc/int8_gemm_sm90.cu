// Int8 GEMM for Hopper (sm_90a) on wgmma fed by TMA: pre-quantized int8 x
// (M, K) with per-row f32 scales times int8 W (N, K) with per-column f32
// scales, int32 sums, then out = act(((f32(acc) * x_scale) * w_scale) + bias)
// written as bf16 or f32; with a null bias the `+ bias` step is left out.
//
// It replaces two Pallas TPU kernels of interactvlm_tpu/ops/int8_matmul.py:
// - `_kernel` / `_kernel_nobias` (wrapper `int8_matmul_fused`) above the
//   one-launch kernel's row threshold, as pass 2 of the two-pass route
//   (wrapper ops/int8_matmul.py:int8_gemm); pass 1 is the row quantize of
//   csrc/int8_prequant.cu. The pair gives the fused kernel's bits: the
//   quantize gives its bytes and scales, the sum is exact, and the epilogue
//   rounds the same products in the same order;
// - `_mm_prequant_kernel` (wrapper `int8_matmul_prequant`, the chain
//   probe's pre-quantized matmul): the same product with no bias,
//   act((f32(acc) * x_scale) * w_scale), so that wrapper launches this
//   kernel with a null bias and gives int8_gemm(..., bias=None)'s bits.
//
// What bounds it on the H100: at the SAM ViT-H encoder's shapes (M = 131 072
// or 156 800, K x N = 1280 x 3840, 1280 x 1280, 1280 x 5120, 5120 x 1280)
// LLaMA-7B prefill's (M = 2552 or 10 208, K, N = 4096 and 11 008) and the
// chain probe's (M = 32 768, K x N = 1280 x 5120 and 5120 x 1280) the
// int8 operations, 2 M K N against M K + N K + 2 M N bytes, 600-1500
// operations a byte above the card's ~590. The fused kernel tops out near
// half the int8 peak on mma.sync fed by cp.async and repeats each row's
// quantize in every column block; here the quantize is done once a row
// (pass 1) and the product runs at the rate only wgmma reaches:
// the persistent, warp-specialized skeleton of gemm_sm90.cuh (128 x 256
// tiles, wgmma m64n256k32 s8 with both operands K-major in shared memory, as
// s8 wgmma requires, a TMA ring of 128-byte K chunks), with the int32 sums
// rescaled in registers by an epilogue compiled for each activation, bias
// and output type.
#include "gemm_sm90.cuh"
#include "matmul_core.cuh"

namespace {

using namespace ivlm;
using namespace ivlm::gemm;

// The rescale of a warp's accumulators in the TPU kernel's order
// (csrc/matmul_core.cuh rescale), each result's f32 bits kept in its
// accumulator.
template <int ACT, bool BIAS, bool OUT_F32>
struct Rescale {
  static constexpr bool kOutF32 = OUT_F32;
  const float* x_scale;  // (M,)
  const float* w_scale;  // (N,)
  const float* bias;     // (N,) or null
  void* out;             // (M, N) bf16 or f32

  __device__ __forceinline__ void apply(int (&acc)[kBN / 2], int row0, int n0,
                                        int M, int N) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
    const int r0 = row0 + g, r1 = r0 + 8;
    const float xs0 = r0 < M ? x_scale[r0] : 0.f;
    const float xs1 = r1 < M ? x_scale[r1] : 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int n = min(n0 + j * 8 + tig * 2, N - 2);  // loads stay inside
      const float2 ws = *reinterpret_cast<const float2*>(w_scale + n);
      const float2 bv = BIAS ? *reinterpret_cast<const float2*>(bias + n)
                             : make_float2(0.f, 0.f);
      acc[4 * j] = __float_as_int(rescale(acc[4 * j], xs0, ws.x, bv.x, BIAS, ACT));
      acc[4 * j + 1] =
          __float_as_int(rescale(acc[4 * j + 1], xs0, ws.y, bv.y, BIAS, ACT));
      acc[4 * j + 2] =
          __float_as_int(rescale(acc[4 * j + 2], xs1, ws.x, bv.x, BIAS, ACT));
      acc[4 * j + 3] =
          __float_as_int(rescale(acc[4 * j + 3], xs1, ws.y, bv.y, BIAS, ACT));
    }
  }
};

template <int ACT, bool BIAS, bool OUT_F32>
__global__ void __launch_bounds__(kThreads, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw,
                     Rescale<ACT, BIAS, OUT_F32> ep, int M, int N, int K,
                     int tiles_m, int tiles_n) {
  gemm_body<S8>(tx, tw, ep, M, N, K, tiles_m, tiles_n);
}

// one kernel for each activation, bias and output type
template <int ACT, bool BIAS, bool OUT_F32>
cudaError_t launch_variant(const void* xq, const void* xs, const void* w,
                           const void* ws, const void* bias, void* out, int M,
                           int N, int K, cudaStream_t st) {
  const Rescale<ACT, BIAS, OUT_F32> ep{static_cast<const float*>(xs),
                                       static_cast<const float*>(ws),
                                       static_cast<const float*>(bias), out};
  return launch<S8>(int8_gemm_kernel<ACT, BIAS, OUT_F32>, xq, w, ep, M, N, K,
                    st);
}

template <int ACT>
cudaError_t launch_act(const void* xq, const void* xs, const void* w,
                       const void* ws, const void* bias, void* out,
                       int out_f32, int M, int N, int K, cudaStream_t st) {
  if (out_f32)
    return bias ? launch_variant<ACT, true, true>(xq, xs, w, ws, bias, out, M, N, K, st)
                : launch_variant<ACT, false, true>(xq, xs, w, ws, bias, out, M, N, K, st);
  return bias ? launch_variant<ACT, true, false>(xq, xs, w, ws, bias, out, M, N, K, st)
              : launch_variant<ACT, false, false>(xq, xs, w, ws, bias, out, M, N, K, st);
}

}  // namespace

// xq: (M, K) int8; xs: (M,) f32; w: (N, K) int8; ws: (N,) f32; bias: (N,)
// f32 or null, all contiguous and 16-byte aligned; out: (M, N) bf16
// (out_f32 = 0) or f32; act: 0 none, 1 exact GELU, 2 tanh GELU. K % 32 == 0,
// N % 8 == 0. Returns the launch status (0 = launched).
extern "C" int ivlm_int8_gemm(const void* xq, const void* xs, const void* w,
                              const void* ws, const void* bias, void* out,
                              int out_f32, int act, int M, int N, int K,
                              void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0 || N % 8 != 0 || act < 0 ||
      act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (act == kGelu)
    err = launch_act<kGelu>(xq, xs, w, ws, bias, out, out_f32, M, N, K, st);
  else if (act == kGeluTanh)
    err = launch_act<kGeluTanh>(xq, xs, w, ws, bias, out, out_f32, M, N, K, st);
  else
    err = launch_act<kNone>(xq, xs, w, ws, bias, out, out_f32, M, N, K, st);
  return static_cast<int>(err);
}

IVLM_EXPORT_ERROR_STRING(ivlm_int8_gemm_sm90)
