// The int8 row quantize for Hopper (sm_90a): pass 1 of the two-pass int8
// matmul, whose pass 2 is the wgmma GEMM of int8_gemm_sm90.cu.
//
// Replaces the Pallas TPU kernel interactvlm_tpu/ops/int8_matmul.py
// `_quantize_kernel` (wrapper `quantize_rows`): x (M, K) bf16 or f32 ->
// xq (M, K) int8 and x_scale (M,) f32. Per row: amax = max|x| (exact in
// f32), inv = 127 / max(amax, 1e-8), x_scale = max(amax, 1e-8) / 127, both
// by IEEE division; xq = clip(rint(x * inv), -127, 127), half to even.
//
// What bounds it on the H100: it reads 2 (bf16) and writes 1 byte an
// element, with no tensor-core work: bytes. One warp owns a row: it loads
// the row into registers (16 bytes a lane a load), takes the absmax with a
// butterfly of shuffles, and quantizes from the same registers, so x is
// read from device memory once. Rows longer than 32 x 32 vectors are read
// twice, the second time mostly from L2. Rows past M are never touched:
// there is no host padding to a row block.
#include "matmul_core.cuh"

namespace {

using namespace ivlm;

constexpr int kRowsPerBlock = 8;  // one warp a row

template <typename TX>
__device__ __forceinline__ void store_q(int8_t* row, int j, const uint2& q) {
  if constexpr (XVec<TX>::kN == 8) {
    reinterpret_cast<uint2*>(row)[j] = q;
  } else {
    reinterpret_cast<uint32_t*>(row)[j] = q.x;
  }
}

// VPL > 0: the row's vectors stay in registers, VPL of them a lane; VPL = 0:
// the row is read twice.
// GIVEN: the row's absmax is amax_in[row], not reduced from the row.
template <typename TX, int VPL, bool GIVEN>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    quantize_rows_kernel(const TX* __restrict__ x, int8_t* __restrict__ xq,
                         float* __restrict__ xs,
                         const float* __restrict__ amax_in, int M, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= M) return;  // the whole warp leaves together
  const int nv = K / XVec<TX>::kN;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * K);
  int8_t* qr = xq + (size_t)row * K;
  float amax = 0.f, inv, scale;
  if constexpr (VPL > 0) {
    uint4 v[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int j = lane + 32 * i;
      v[i] = j < nv ? xr[j] : make_uint4(0u, 0u, 0u, 0u);
      if constexpr (!GIVEN) amax = vec_amax<TX>(v[i], amax);
    }
    row_scales(GIVEN ? amax_in[row] : warp_max(amax), inv, scale);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int j = lane + 32 * i;
      if (j < nv) store_q<TX>(qr, j, quant_vec<TX>(v[i], inv));
    }
  } else {
    if constexpr (!GIVEN) {
      for (int j = lane; j < nv; j += 32) amax = vec_amax<TX>(xr[j], amax);
    }
    row_scales(GIVEN ? amax_in[row] : warp_max(amax), inv, scale);
    for (int j = lane; j < nv; j += 32) store_q<TX>(qr, j, quant_vec<TX>(xr[j], inv));
  }
  if (lane == 0) xs[row] = scale;
}

template <typename TX, bool GIVEN>
cudaError_t launch_quantize(const void* x, void* xq, void* xs,
                            const void* amax, int M, int K, cudaStream_t st) {
  const TX* xp = static_cast<const TX*>(x);
  int8_t* qp = static_cast<int8_t*>(xq);
  float* sp = static_cast<float*>(xs);
  const float* ap = static_cast<const float*>(amax);
  const int per_lane = (K / XVec<TX>::kN + 31) / 32;
  const dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(kRowsPerBlock * 32);
#define IVLM_QUANT(V) \
  quantize_rows_kernel<TX, V, GIVEN><<<grid, block, 0, st>>>(xp, qp, sp, ap, M, K)
  if (per_lane <= 2) {
    IVLM_QUANT(2);
  } else if (per_lane <= 4) {
    IVLM_QUANT(4);
  } else if (per_lane <= 8) {
    IVLM_QUANT(8);
  } else if (per_lane <= 16) {
    IVLM_QUANT(16);
  } else if (per_lane <= 24) {
    IVLM_QUANT(24);
  } else if (per_lane <= 32) {
    IVLM_QUANT(32);
  } else {
    IVLM_QUANT(0);
  }
#undef IVLM_QUANT
  return cudaGetLastError();
}

}  // namespace

// x: (M, K) bf16 (x_f32 = 0) or f32, contiguous, K % 8 == 0; xq: (M, K)
// int8; xs: (M,) f32. Returns the launch status (0 = launched).
extern "C" int ivlm_quantize_rows(const void* x, int x_f32, void* xq, void* xs,
                                  int M, int K, void* stream) {
  if (M <= 0 || K <= 0 || K % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_f32 ? launch_quantize<float, false>(x, xq, xs, nullptr, M, K, st)
            : launch_quantize<bf16, false>(x, xq, xs, nullptr, M, K, st);
  return static_cast<int>(err);
}

// The given-scale route: as ivlm_quantize_rows, with each row's absmax
// read from amax (M,) f32 (the row's max |x| over its whole length, of
// which x holds a slice) instead of reduced from x.
extern "C" int ivlm_quantize_rows_given(const void* x, int x_f32,
                                        const void* amax, void* xq, void* xs,
                                        int M, int K, void* stream) {
  if (M <= 0 || K <= 0 || K % 8 != 0 || amax == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_f32 ? launch_quantize<float, true>(x, xq, xs, amax, M, K, st)
            : launch_quantize<bf16, true>(x, xq, xs, amax, M, K, st);
  return static_cast<int>(err);
}

IVLM_EXPORT_ERROR_STRING(ivlm_int8_prequant)
