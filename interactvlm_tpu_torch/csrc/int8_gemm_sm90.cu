// Int8 GEMM for Hopper (sm_90a) on wgmma fed by TMA: pre-quantized int8 x
// (M, K) with per-row f32 scales times int8 W (N, K) with per-column f32
// scales, int32 sums, then out = act(((f32(acc) * x_scale) * w_scale) + bias)
// written as bf16 or f32.
//
// Pass 2 of the two-pass route of the fused int8 matmul (wrapper
// ops/int8_matmul.py:int8_matmul_fused, rows above the one-launch kernel's
// threshold); pass 1 is the row quantize of csrc/int8_prequant.cu. Together
// they replace the Pallas TPU kernel interactvlm_tpu/ops/int8_matmul.py
// `_kernel` / `_kernel_nobias` at those rows, with the same bits: the
// quantize gives the fused kernel's bytes and scales, the sum is exact, and
// the epilogue rounds the same products in the same order.
//
// What bounds it on the H100: at the SAM ViT-H encoder's shapes (M = 131 072
// or 156 800, K x N = 1280 x 3840, 1280 x 1280, 1280 x 5120, 5120 x 1280)
// and LLaMA-7B prefill's (M = 2552 or 10 208, K, N = 4096 and 11 008) the
// int8 operations, 2 M K N against M K + N K + 2 M N bytes, 600-1500
// operations a byte above the card's ~590. The fused kernel tops out near
// half the int8 peak on mma.sync fed by cp.async and repeats each row's
// quantize in every column block; here the quantize is done once a row
// (pass 1) and the product runs at the rate only wgmma reaches:
// - a CTA computes 128 x 256 tiles: two consumer warpgroups of 64 rows each
//   run wgmma m64n256k32 s8 with both operands from shared memory (both are
//   K-major, as s8 wgmma requires), the int32 sums in registers (256 columns
//   took 1.314 ms at the SAM qkv shape against 1.588 for 128 on an H100 80GB
//   HBM3 at 700 W, PERF.md);
// - one producer thread keeps a ring of K chunks of 128 bytes full by TMA
//   (128-byte swizzle, full/empty mbarriers), with its warpgroup's
//   registers given to the consumers by setmaxnreg;
// - the grid is persistent, one CTA an SM, walking tiles in groups of 16
//   row blocks with the row block fastest, so a group's x rows and the W
//   columns it sweeps stay in L2 while the next tile's chunks load during
//   this tile's epilogue;
// - the epilogue runs from the accumulator registers, compiled for each
//   activation, bias and output type (a branch per element kept the column
//   scale loads from being issued together, and cost more than the
//   products); each warp passes its rows through a small shared-memory
//   buffer so that lanes store whole 16-byte pieces of 128-byte row
//   segments, rows past M and columns past N masked. TMA fills reads past
//   M, N or K with zeros, so a ragged K chunk adds nothing and no operand is
//   padded on the host.
#include "matmul_core.cuh"
#include "sm90_core.cuh"

#include <type_traits>

namespace {

using namespace ivlm;
using namespace ivlm::sm90;

constexpr int kBM = 128;       // rows a tile: two consumer warpgroups of 64
constexpr int kBN = 256;       // columns a tile
constexpr int kBK = 128;       // K bytes a stage: one 128-byte swizzle row
constexpr int kGroupM = 16;    // row blocks a raster group
constexpr int kThreads = 384;  // warpgroups 0, 1 consume; 2 produces
constexpr int kOutRow = 144;   // bytes a row of a warp's output buffer:
                               // 128 of data, 16 against bank conflicts

constexpr int kStages = 4;
constexpr int kABytes = kBM * kBK;
constexpr int kBBytes = kBN * kBK;
constexpr int kRing = kStages * (kABytes + kBBytes);
constexpr int kOut = 8 * 16 * kOutRow;  // a buffer a consumer warp
constexpr int kSmem = 1024 + kRing + kOut + 2 * kStages * 8;

struct Epilogue {
  const float* x_scale;  // (M,)
  const float* w_scale;  // (N,)
  const float* bias;     // (N,) or null
  void* out;             // (M, N) bf16 or f32
};

__device__ __forceinline__ void tile_coords(int t, int tiles_m, int tiles_n,
                                            int& tm, int& tn) {
  const int per_group = kGroupM * tiles_n;
  const int first = (t / per_group) * kGroupM;
  const int rows = min(kGroupM, tiles_m - first);
  const int local = t % per_group;
  tm = first + local % rows;
  tn = local / rows;
}

// The warp's 16 rows x 256 columns of the tile, from its accumulators to
// the output: rescaled in place (the TPU kernel's order, csrc/matmul_core.cuh
// rescale), then, 128 bytes of each row at a time, written into the warp's
// shared buffer in the accumulator layout and read back as 16-byte pieces
// of whole rows, which the lanes store.
template <int ACT, bool BIAS, bool OUT_F32>
__device__ __forceinline__ void epilogue(int (&acc)[kBN / 2], const Epilogue& ep,
                                         unsigned char* buf, int row0, int n0,
                                         int M, int N) {
  using T = typename std::conditional<OUT_F32, float, bf16>::type;
  constexpr int E = (int)sizeof(T);
  constexpr int CH = 128 / E;  // columns a 128-byte row segment
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int r0 = row0 + g, r1 = r0 + 8;
  const float xs0 = r0 < M ? ep.x_scale[r0] : 0.f;
  const float xs1 = r1 < M ? ep.x_scale[r1] : 0.f;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int n = min(n0 + j * 8 + tig * 2, N - 2);  // loads stay inside
    const float2 ws = *reinterpret_cast<const float2*>(ep.w_scale + n);
    const float2 bv = BIAS ? *reinterpret_cast<const float2*>(ep.bias + n)
                           : make_float2(0.f, 0.f);
    acc[4 * j] = __float_as_int(rescale(acc[4 * j], xs0, ws.x, bv.x, BIAS, ACT));
    acc[4 * j + 1] =
        __float_as_int(rescale(acc[4 * j + 1], xs0, ws.y, bv.y, BIAS, ACT));
    acc[4 * j + 2] =
        __float_as_int(rescale(acc[4 * j + 2], xs1, ws.x, bv.x, BIAS, ACT));
    acc[4 * j + 3] =
        __float_as_int(rescale(acc[4 * j + 3], xs1, ws.y, bv.y, BIAS, ACT));
  }
#pragma unroll
  for (int c = 0; c < kBN / CH; ++c) {
#pragma unroll
    for (int jj = 0; jj < CH / 8; ++jj) {
      const int j = c * (CH / 8) + jj;
      unsigned char* p = buf + g * kOutRow + (jj * 8 + tig * 2) * E;
      const float v0 = __int_as_float(acc[4 * j]), v1 = __int_as_float(acc[4 * j + 1]);
      const float v2 = __int_as_float(acc[4 * j + 2]), v3 = __int_as_float(acc[4 * j + 3]);
      if constexpr (OUT_F32) {
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        *reinterpret_cast<float2*>(p + 8 * kOutRow) = make_float2(v2, v3);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(p + 8 * kOutRow) =
            __floats2bfloat162_rn(v2, v3);
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // 16 rows x 8 pieces, 4 a lane
      const int piece = lane + 32 * i, row = piece >> 3, seg = piece & 7;
      const int m = row0 + row, n = n0 + c * CH + seg * (16 / E);
      const uint4 v = *reinterpret_cast<const uint4*>(buf + row * kOutRow + seg * 16);
      if (m < M && n < N)  // N % 8 == 0: a piece is all in or all out
        *reinterpret_cast<uint4*>(static_cast<T*>(ep.out) + (size_t)m * N + n) = v;
    }
    __syncwarp();
  }
}

template <int ACT, bool BIAS, bool OUT_F32>
__global__ void __launch_bounds__(kThreads, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw, Epilogue ep,
                     int M, int N, int K, int tiles_m, int tiles_n) {
  constexpr int S = kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* a_ring = smem;                   // S x (128 x 128) int8
  unsigned char* b_ring = smem + S * kABytes;  // S x (256 x 128) int8
  unsigned char* out_buf = smem + kRing;       // 8 x 16 rows
  uint64_t* full = reinterpret_cast<uint64_t*>(out_buf + kOut);
  uint64_t* empty = full + S;

  const int nk = (K + kBK - 1) / kBK;
  const int ntiles = tiles_m * tiles_n;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival with its bytes
      mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every TMA load
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        int tm, tn;
        tile_coords(t, tiles_m, tiles_n, tm, tn);
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], kABytes + kBBytes);
          tma_load_2d(a_ring + stage * kABytes, &tx, &full[stage],
                      kb * kBK, tm * kBM);
          tma_load_2d(b_ring + stage * kBBytes, &tw, &full[stage],
                      kb * kBK, tn * kBN);
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a tile
    setmaxnreg_inc<232>();
    const int warp = threadIdx.x >> 5;  // 0..7
    unsigned char* buf = out_buf + warp * 16 * kOutRow;
    int stage = 0;
    uint32_t phase = 0;
    int acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      int tm, tn;
      tile_coords(t, tiles_m, tiles_n, tm, tn);
      int prev = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint32_t a = smem_addr(a_ring + stage * kABytes) + wg * 64 * kBK;
        const uint32_t b = smem_addr(b_ring + stage * kBBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)
          wgmma_s8_n256(acc, desc_kmajor(a + kk * 32),
                        desc_kmajor(b + kk * 32), (kb > 0 || kk > 0) ? 1 : 0);
        wgmma_commit();
        if (kb > 0) {  // the previous chunk's products are done: free it
          wgmma_wait<1>();
          if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[prev]);
      fence_regs(acc);
      epilogue<ACT, BIAS, OUT_F32>(acc, ep, buf, tm * kBM + warp * 16,
                                   tn * kBN, M, N);
    }
  }
}

template <int ACT, bool BIAS, bool OUT_F32>
cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& tw,
                   const Epilogue& ep, int M, int N, int K, cudaStream_t st) {
  auto kernel = int8_gemm_kernel<ACT, BIAS, OUT_F32>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const int tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + kBN - 1) / kBN;
  const int grid = min(sm_count(), tiles_m * tiles_n);
  kernel<<<grid, kThreads, kSmem, st>>>(tx, tw, ep, M, N, K, tiles_m, tiles_n);
  return cudaGetLastError();
}

// one kernel for each activation, bias and output type
template <int ACT>
cudaError_t launch_act(const CUtensorMap& tx, const CUtensorMap& tw,
                       const Epilogue& ep, int out_f32, int M, int N, int K,
                       cudaStream_t st) {
  const bool bias = ep.bias != nullptr;
  if (out_f32)
    return bias ? launch<ACT, true, true>(tx, tw, ep, M, N, K, st)
                : launch<ACT, false, true>(tx, tw, ep, M, N, K, st);
  return bias ? launch<ACT, true, false>(tx, tw, ep, M, N, K, st)
              : launch<ACT, false, false>(tx, tw, ep, M, N, K, st);
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
  const Epilogue ep{static_cast<const float*>(xs),
                    static_cast<const float*>(ws),
                    static_cast<const float*>(bias), out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap tx, tw;
  const cuuint64_t dx[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t dw[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t stride[1] = {(cuuint64_t)K};
  const cuuint32_t bx[2] = {kBK, kBM}, bw[2] = {kBK, kBN};
  if (!encode_sw128(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xq, dx, stride, bx) ||
      !encode_sw128(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, dw, stride, bw))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (act == kGelu)
    err = launch_act<kGelu>(tx, tw, ep, out_f32, M, N, K, st);
  else if (act == kGeluTanh)
    err = launch_act<kGeluTanh>(tx, tw, ep, out_f32, M, N, K, st);
  else
    err = launch_act<kNone>(tx, tw, ep, out_f32, M, N, K, st);
  return static_cast<int>(err);
}

IVLM_EXPORT_ERROR_STRING(ivlm_int8_gemm_sm90)
