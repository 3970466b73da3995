// Fused int8 quantize + matmul for Hopper (sm_90a): x (M, K) bf16 or f32,
// quantized per row inside the kernel, times int8 W (N, K) with per-column
// f32 scales, int32 accumulation on the int8 tensor cores, then the rescale,
// an optional f32 bias and an optional GELU, written as bf16 or f32.
//
// Replaces the Pallas TPU kernel interactvlm_tpu/ops/int8_matmul.py `_kernel`
// / `_kernel_nobias` (wrapper `int8_matmul_fused`). Per row: amax = max|x|
// over K, x_scale = max(amax, 1e-8) / 127, inv = 127 / max(amax, 1e-8),
// xq = clip(rint(x * inv), -127, 127) (round half to even, as jnp.round);
// out = act(f32(acc) * x_scale * w_scale + bias).
//
// What bounds it on the H100, at the shapes it runs (LLaMA-7B decode and
// the lm_head, M = 8 or 32): the int8 weight bytes, read once per step.
// The TPU kernel kept the whole (K, N) weight resident in VMEM and swept row
// blocks in order. Here the output is tiled instead, and blocks run in
// parallel: each block first takes the absmax of its BM rows of x in one
// pass, then streams K in BK-wide chunks, quantizing the x chunk into shared
// memory as int8 (registers prefetch the next chunk during the products; the
// second read of x mostly hits L2, as all column blocks of a row block run
// next to each other) while W chunks arrive through a cp.async ring. The
// products run on mma.sync m16n8k32 s8 with fragments from ldmatrix; the
// int32 accumulators stay in registers and are rescaled once. Rows past M and
// columns past N are masked in-kernel (no host padding). The tiling is for
// decode: 32 x 32 blocks of 4 warps with a 4-deep weight ring, where only
// the count of blocks in flight (N / 32 of them) keeps enough weight bytes
// moving. The wrapper sends more rows than ops/int8_matmul.py's
// ONE_LAUNCH_MAX_ROWS to the two-pass route instead (csrc/int8_prequant.cu's
// row quantize, then csrc/int8_gemm_sm90.cu), which beat this kernel's
// former 64 x 128 tiling at every encoder and prefill shape.
#include "matmul_core.cuh"

namespace {

using namespace ivlm;

struct Epilogue {
  const float* w_scale;
  const float* bias;  // null: no bias
  void* out;
  int out_f32;
  int act;
};

template <class TL, typename TX>
__global__ void __launch_bounds__(TL::kThreads)
    int8_matmul_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                       Epilogue ep, int M, int N, int K) {
  constexpr int BM = TL::BM, BN = TL::BN, BK = TL::BK, STAGES = TL::STAGES;
  constexpr int NTHREADS = TL::kThreads, NWARPS = NTHREADS / 32;
  constexpr int LDS = TL::kLds;
  constexpr int VEC = XVec<TX>::kN;
  constexpr int XV = BM * BK / VEC / NTHREADS;  // x vectors a thread loads
  static_assert(XV >= 1 && XV * VEC * NTHREADS == BM * BK, "x chunk");
  static_assert(BM % NWARPS == 0, "rows");

  __shared__ __align__(16) int8_t xq_s[2][BM][LDS];
  __shared__ __align__(16) int8_t w_s[STAGES][BN][LDS];
  __shared__ float inv_s[BM];
  __shared__ float xs_s[BM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nchunks = (K + BK - 1) / BK;

  // pass 1: the per-row absmax over the whole of K, in f32 (exact: |x| and
  // max are exact in x's own type, and widening bf16 to f32 is exact)
  for (int i = 0; i < BM / NWARPS; ++i) {
    const int r = warp * (BM / NWARPS) + i;
    float amax = 0.f;
    if (m0 + r < M) {
      const uint4* row = reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K);
      for (int v = lane; v < K / VEC; v += 32) amax = vec_amax<TX>(row[v], amax);
    }
    amax = warp_max(amax);
    if (lane == 0) row_scales(amax, inv_s[r], xs_s[r]);
  }

  auto load_w = [&](int slot, int c) {
    load_chunk<int8_t, BN, BK, LDS, NTHREADS>(w_s[slot], w, n0, N, c * BK, K,
                                              tid);
  };
  auto load_x = [&](int c, uint4 (&xr)[XV]) {
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int t = tid + i * NTHREADS;
      const int r = t / (BK / VEC), kv = (t % (BK / VEC)) * VEC;
      const int gk = c * BK + kv;
      xr[i] = (m0 + r < M && gk < K)
                  ? *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + gk)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store_xq = [&](int buf, const uint4 (&xr)[XV]) {
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int t = tid + i * NTHREADS;
      const int r = t / (BK / VEC), kv = (t % (BK / VEC)) * VEC;
      const uint2 q = quant_vec<TX>(xr[i], inv_s[r]);
      if constexpr (VEC == 8) {
        *reinterpret_cast<uint2*>(&xq_s[buf][r][kv]) = q;
      } else {
        *reinterpret_cast<uint32_t*>(&xq_s[buf][r][kv]) = q.x;
      }
    }
  };

  int acc[TL::MT][TL::NT][4];
  zero_acc(acc);
  const int wm = (warp / TL::WARPS_N) * TL::WTM;
  const int wn = (warp % TL::WARPS_N) * TL::WTN;
  uint4 xr[XV];

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) load_w(s, s);
    cp_async_commit();  // empty groups keep the count uniform
  }
  __syncthreads();  // inv_s is written
  load_x(0, xr);
  store_xq(0, xr);

  for (int c = 0; c < nchunks; ++c) {
    // chunk c's W has landed and chunk c's x is quantized; every warp has
    // also finished reading the slot and buffer written below
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int cn = c + STAGES - 1;
    if (cn < nchunks) load_w(cn % STAGES, cn);
    cp_async_commit();
    if (c + 1 < nchunks) load_x(c + 1, xr);  // in flight during the products
    mma_chunk<TL>(acc, xq_s[c & 1], w_s[c % STAGES], wm, wn, lane);
    if (c + 1 < nchunks) store_xq((c + 1) & 1, xr);
  }
  cp_async_wait<0>();

  const bool has_bias = ep.bias != nullptr;
  auto col = [&](int n) {  // the column pair's scales and biases
    return make_float4(ep.w_scale[n], ep.w_scale[n + 1],
                       has_bias ? ep.bias[n] : 0.f,
                       has_bias ? ep.bias[n + 1] : 0.f);
  };
  for_each_pair<TL>(acc, m0, n0, M, N, col,
                    [&](const float4& c, int m, int n, int a0, int a1) {
    const float xs = xs_s[m - m0];
    store2(ep.out, (size_t)m * N + n, ep.out_f32,
           rescale(a0, xs, c.x, c.z, has_bias, ep.act),
           rescale(a1, xs, c.y, c.w, has_bias, ep.act));
  });
}

// 32 x 32 tiles, 4 warps of 16 x 16, 4-deep weight ring
using Small = Tile<int8_t, 32, 32, 128, 2, 2, 4>;

template <typename TX>
cudaError_t launch(const void* x, const void* w, const Epilogue& ep, int M,
                   int N, int K, cudaStream_t st) {
  const int row_blocks = (M + Small::BM - 1) / Small::BM;
  if (row_blocks > 65535) return cudaErrorInvalidValue;
  const dim3 grid((N + Small::BN - 1) / Small::BN, row_blocks);
  int8_matmul_kernel<Small, TX><<<grid, Small::kThreads, 0, st>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(w), ep, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// x: (M, K) bf16 (x_f32 = 0) or f32, contiguous; w: (N, K) int8, contiguous;
// w_scale: (N,) f32; bias: (N,) f32 or null; out: (M, N) bf16 (out_f32 = 0)
// or f32; act: 0 none, 1 exact GELU, 2 tanh GELU. K % 32 == 0, N % 8 == 0,
// every pointer 16-byte aligned. Returns the launch status (0 = launched).
extern "C" int ivlm_int8_matmul(const void* x, int x_f32, const void* w,
                                const void* w_scale, const void* bias,
                                void* out, int out_f32, int act, int M, int N,
                                int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0 || N % 8 != 0 || act < 0 ||
      act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue ep{static_cast<const float*>(w_scale),
                    static_cast<const float*>(bias), out, out_f32, act};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = x_f32 ? launch<float>(x, w, ep, M, N, K, st)
                                : launch<bf16>(x, w, ep, M, N, K, st);
  return static_cast<int>(err);
}

IVLM_EXPORT_ERROR_STRING(ivlm_int8_matmul)
