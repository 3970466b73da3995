// The two-pass int8 matmul for Hopper (sm_90a): a per-row int8 quantize of
// the activations, then a pure int8 x int8 -> int32 matmul with the rescale
// and an optional GELU in its epilogue.
//
// Replaces two Pallas TPU kernels of interactvlm_tpu/ops/int8_matmul.py:
// - `_quantize_kernel` (wrapper `quantize_rows`): x (M, K) bf16 or f32 ->
//   xq (M, K) int8 and x_scale (M,) f32. Per row: amax = max|x| (exact in
//   f32), inv = 127 / max(amax, 1e-8), x_scale = max(amax, 1e-8) / 127, both
//   by IEEE division; xq = clip(rint(x * inv), -127, 127), half to even.
// - `_mm_prequant_kernel` (wrapper `int8_matmul_prequant`): xq (M, K) int8
//   times int8 W (N, K) (the port's layout, K-contiguous per output column)
//   with per-column f32 scales; out = act((f32(acc) * x_scale) * w_scale) in
//   f32, no bias, written as bf16 or f32.
//
// What bounds them on the H100:
// - the quantize reads 2 (bf16) and writes 1 byte an element, with no
//   tensor-core work: bytes. One warp owns a row: it loads the row into
//   registers (16 bytes a lane a load), takes the absmax with a butterfly of
//   shuffles, and quantizes from the same registers, so x is read from
//   device memory once. Rows longer than 32 x 32 vectors are read twice,
//   the second time mostly from L2. Rows past M are never touched: there is
//   no host padding to a row block.
// - the matmul at the chain probe's shapes (M = 32 768, K x N = 1280 x 5120
//   and 5120 x 1280) does 2 M K N int8 operations against M K + K N + 2 M N
//   bytes, ~1000 operations a byte, above the card's ~590 int8 operations a
//   byte: the int8 tensor cores. The TPU kernel kept the whole (K, N) weight
//   resident in VMEM; here blocks own 64 x 128 output tiles and run in
//   parallel, and both operands stream through a 3-deep cp.async ring in
//   64-wide K chunks, with mma.sync m16n8k32 s8 on ldmatrix fragments. The
//   tiling is kernel 6's (csrc/int8_matmul.cu) less its in-block quantize, so
//   the two time the cost of that quantize against the second pass.
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
template <typename TX, int VPL>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    quantize_rows_kernel(const TX* __restrict__ x, int8_t* __restrict__ xq,
                         float* __restrict__ xs, int M, int K) {
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
      amax = vec_amax<TX>(v[i], amax);
    }
    row_scales(warp_max(amax), inv, scale);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int j = lane + 32 * i;
      if (j < nv) store_q<TX>(qr, j, quant_vec<TX>(v[i], inv));
    }
  } else {
    for (int j = lane; j < nv; j += 32) amax = vec_amax<TX>(xr[j], amax);
    row_scales(warp_max(amax), inv, scale);
    for (int j = lane; j < nv; j += 32) store_q<TX>(qr, j, quant_vec<TX>(xr[j], inv));
  }
  if (lane == 0) xs[row] = scale;
}

template <typename TX>
cudaError_t launch_quantize(const void* x, void* xq, void* xs, int M, int K,
                            cudaStream_t st) {
  const TX* xp = static_cast<const TX*>(x);
  int8_t* qp = static_cast<int8_t*>(xq);
  float* sp = static_cast<float*>(xs);
  const int per_lane = (K / XVec<TX>::kN + 31) / 32;
  const dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(kRowsPerBlock * 32);
#define IVLM_QUANT(V) quantize_rows_kernel<TX, V><<<grid, block, 0, st>>>(xp, qp, sp, M, K)
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

struct Epilogue {
  const float* x_scale;
  const float* w_scale;
  void* out;
  int out_f32;
  int act;
};

// 64 x 128 output tiles, 8 warps of 32 x 32, a 3-deep ring of 64-wide K
// chunks of both operands (45 KB of static shared memory)
using Prequant = Tile<int8_t, 64, 128, 64, 2, 4, 3>;

template <class TL>
__global__ void __launch_bounds__(TL::kThreads)
    prequant_matmul_kernel(const int8_t* __restrict__ xq,
                           const int8_t* __restrict__ w, Epilogue ep, int M,
                           int N, int K) {
  __shared__ __align__(16) unsigned char smem[TL::kSmem];
  const int n0 = blockIdx.x * TL::BN, m0 = blockIdx.y * TL::BM;
  int acc[TL::MT][TL::NT][4];
  mainloop<TL>(acc, xq, w, smem, m0, n0, M, N, K);
  // the order of the TPU kernel, (acc * x_scale) * w_scale, then the
  // activation, each rounded on its own
  auto col = [&](int n) {
    return make_float2(ep.w_scale[n], ep.w_scale[n + 1]);
  };
  for_each_pair<TL>(acc, m0, n0, M, N, col,
                    [&](const float2& ws, int m, int n, int a0, int a1) {
    const float xs = ep.x_scale[m];
    const float v0 =
        apply_act(__fmul_rn(__fmul_rn(__int2float_rn(a0), xs), ws.x), ep.act);
    const float v1 =
        apply_act(__fmul_rn(__fmul_rn(__int2float_rn(a1), xs), ws.y), ep.act);
    store2(ep.out, (size_t)m * N + n, ep.out_f32, v0, v1);
  });
}


}  // namespace

// x: (M, K) bf16 (x_f32 = 0) or f32, contiguous, K % 8 == 0; xq: (M, K)
// int8; xs: (M,) f32. Returns the launch status (0 = launched).
extern "C" int ivlm_quantize_rows(const void* x, int x_f32, void* xq, void* xs,
                                  int M, int K, void* stream) {
  if (M <= 0 || K <= 0 || K % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = x_f32 ? launch_quantize<float>(x, xq, xs, M, K, st)
                                : launch_quantize<bf16>(x, xq, xs, M, K, st);
  return static_cast<int>(err);
}

// xq: (M, K) int8; xs: (M,) f32; w: (N, K) int8; ws: (N,) f32, all
// contiguous and 16-byte aligned; out: (M, N) bf16 (out_f32 = 0) or f32;
// act: 0 none, 1 exact GELU, 2 tanh GELU. K % 32 == 0, N % 8 == 0.
extern "C" int ivlm_int8_prequant_matmul(const void* xq, const void* xs,
                                         const void* w, const void* ws,
                                         void* out, int out_f32, int act,
                                         int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0 || N % 8 != 0 || act < 0 ||
      act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_blocks = (M + Prequant::BM - 1) / Prequant::BM;
  if (row_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue ep{static_cast<const float*>(xs),
                    static_cast<const float*>(ws), out, out_f32, act};
  const dim3 grid((N + Prequant::BN - 1) / Prequant::BN, row_blocks);
  prequant_matmul_kernel<Prequant>
      <<<grid, Prequant::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w), ep, M,
          N, K);
  return static_cast<int>(cudaGetLastError());
}

IVLM_EXPORT_ERROR_STRING(ivlm_int8_prequant)
