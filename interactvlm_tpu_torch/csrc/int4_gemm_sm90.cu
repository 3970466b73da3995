// Int4-weight GEMM for Hopper (sm_90a) on wgmma fed by TMA: pre-quantized
// int8 x (M, K) with per-row f32 scales times a packed int4 weight (N, K/2)
// with per-column f32 scales, int32 sums, then
// out = (f32(acc) * x_scale) * w_scale written as bf16 or f32. Byte j of a
// weight row holds column j in its low nibble and column j + K/2 in its
// high one (ops/quant.py:pack_int4), so
// acc = sum_{j < K/2} xq[j] lo[j] + xq[K/2 + j] hi[j].
//
// Pass 2 of the two-pass int4 matmul (wrapper ops/int4_matmul.py:int4_gemm;
// pass 1 is kernel 7 with the row factor, csrc/int8_prequant.cu, which
// quantizes x * rf), taken above the one-launch kernel's 32 rows (LLaMA-7B
// prefill) and by the row-parallel int4 linear at every row count. It
// replaces no Pallas kernel: the JAX package leaves the int4 product to
// XLA's fusion of the unpack into its two half-K dots
// (interactvlm_tpu/ops/quant.py:int4_matmul). It was added because the
// card's only other route unpacked each weight into a transient (N, K)
// int8 copy and ran the int8 GEMM on it: three passes over twice the
// weight's bytes.
//
// What bounds it on the H100: at LLaMA-7B prefill (M = 2552, K x N = 4096 x
// 4096, 4096 x 11008, 11008 x 4096) the int8 operations, 2 M K N against
// M K + N K / 2 + 2 M N bytes. s8 wgmma takes B from shared memory only, so
// the weight, which must be unpacked by threads, is operand A, in
// registers:
// - a CTA computes 128 weight rows (output columns) x 128 x rows: two
//   consumer warpgroups of 64 weight rows each, wgmma m64n128k32 with A from
//   registers and B (x's rows, K-major) from shared memory, the sums of
//   each warpgroup in 64 registers a thread, transposed (weight rows down,
//   x rows across);
// - one producer thread keeps a ring of 4 stages full by TMA (128-byte
//   swizzle): a stage is one packed chunk of 128 bytes a weight row (256 K
//   values, 16 KB) and the two x tiles it multiplies, columns
//   [128 kb, 128 kb + 128) and K/2 plus those (16 KB each), the x tiles
//   cut from x seen as (M, 2, K/2) so that each half's edge fills zeros;
// - each consumer thread reads its A fragments (the mma.m16n8k32 layout)
//   from the swizzled packed tile, splits every word into its low and high
//   nibbles, sign-extended bytewise (matmul_core.cuh unpack_nibbles), and
//   runs the low nibbles against the first x tile and the high ones
//   against the second: a byte's two nibbles sit at the same fragment
//   position of the two products. The next chunk's words are read while
//   the last chunk's products run; its nibbles are split once they are
//   done, since the products read A from those registers;
// - the grid is persistent, one CTA an SM, walking tiles in groups of 16 x
//   row blocks (gemm_sm90.cuh tile_coords); the epilogue rescales each
//   accumulator in the int8 kernels' order (matmul_core.cuh rescale, no
//   bias, no activation) and stores it at its transposed place, rows past
//   M and columns past N masked. TMA fills reads past N or K with zeros,
//   and a zero byte unpacks to two zero weights, so no operand is padded.
#include "gemm_sm90.cuh"
#include "matmul_core.cuh"

namespace {

using namespace ivlm;
using namespace ivlm::sm90;

constexpr int kBW = 128;       // weight rows (output columns) a tile
constexpr int kBX = 128;       // x rows a tile
constexpr int kChunk = 128;    // packed bytes a weight row a stage
constexpr int kStages = 4;
constexpr int kThreads = 384;  // warpgroups 0, 1 consume; 2 produces
constexpr int kWBytes = kBW * kChunk;
constexpr int kXBytes = kBX * kChunk;            // one half's x tile
constexpr int kStage = kWBytes + 2 * kXBytes;    // 48 KB
constexpr int kSmem = 1024 + kStages * kStage + 2 * kStages * 8;

template <bool OUT_F32>
__global__ void __launch_bounds__(kThreads, 1)
    int4_gemm_kernel(const __grid_constant__ CUtensorMap tw,
                     const __grid_constant__ CUtensorMap tx,
                     const float* __restrict__ x_scale,
                     const float* __restrict__ w_scale, void* __restrict__ out,
                     int M, int N, int K, int tiles_m, int tiles_n) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  uint64_t* empty = full + kStages;

  const int nk = (K / 2 + kChunk - 1) / kChunk;
  const int ntiles = tiles_m * tiles_n;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
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
        int tm, tn;  // x-row block, weight-row block
        gemm::tile_coords(t, tiles_m, tiles_n, tm, tn);
        for (int kb = 0; kb < nk; ++kb) {
          unsigned char* st = smem + stage * kStage;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], kStage);
          tma_load_2d(st, &tw, &full[stage], kb * kChunk, tn * kBW);
          tma_load_3d(st + kWBytes, &tx, &full[stage], kb * kChunk, 0,
                      tm * kBX);
          tma_load_3d(st + kWBytes + kXBytes, &tx, &full[stage], kb * kChunk,
                      1, tm * kBX);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns weight rows 64 wg .. 64 wg + 63 of a
  // tile; warp w of it rows 16 w .. 16 w + 15 of those
  setmaxnreg_inc<232>();
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int gr = lane >> 2, t4 = lane & 3;
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  int acc[kBW / 2];
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    int tm, tn;
    gemm::tile_coords(t, tiles_m, tiles_n, tm, tn);
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&full[stage], phase);
      const unsigned char* st = smem + stage * kStage;
      // the warp's A words: row 64 wg + 16 w + gr (+ 8 for i odd), packed
      // columns 32 kk + 4 t4 (+ 16 for i >= 2), 128-byte swizzled
      uint32_t raw[kChunk / 32][4];
#pragma unroll
      for (int kk = 0; kk < kChunk / 32; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          raw[kk][i] = *reinterpret_cast<const uint32_t*>(
              st + sw128_offset(64 * wg + 16 * w + gr + 8 * (i & 1),
                                32 * kk + 16 * (i >> 1) + 4 * t4));
      // the last chunk's products are done: their A registers may be
      // rewritten and their stage, whose x tiles they read, refilled (a
      // second set of A registers filled while they run makes ptxas
      // serialize the products, C7513: slower)
      wgmma_wait<0>();
      if (kb > 0 && (threadIdx.x & 127) == 0) mbar_arrive(&empty[prev]);
      uint32_t lo[kChunk / 32][4], hi[kChunk / 32][4];
#pragma unroll
      for (int kk = 0; kk < kChunk / 32; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          unpack_nibbles(raw[kk][i], lo[kk][i], hi[kk][i]);
      wgmma_fence();
      const uint32_t b_lo = smem_addr(st + kWBytes);
      const uint32_t b_hi = b_lo + kXBytes;
#pragma unroll
      for (int kk = 0; kk < kChunk / 32; ++kk) {
        wgmma_s8_rs_n128(acc, lo[kk], desc_kmajor(b_lo + kk * 32),
                         (kb > 0 || kk > 0) ? 1 : 0);
        wgmma_s8_rs_n128(acc, hi[kk], desc_kmajor(b_hi + kk * 32), 1);
      }
      wgmma_commit();
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[prev]);
    fence_regs(acc);
    // element 4 j + e: weight row n = 64 wg + 16 w + gr + 8 (e / 2), x row
    // m = 8 j + 2 t4 + e % 2 of the tile; out[m, n]
    const int n0 = tn * kBW + 64 * wg + 16 * w + gr, m0 = tm * kBX + 2 * t4;
    float ws[2];
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2)
      ws[e2] = n0 + 8 * e2 < N ? w_scale[n0 + 8 * e2] : 0.f;
#pragma unroll
    for (int j = 0; j < kBX / 8; ++j)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int m = m0 + 8 * j + e1;
        if (m >= M) continue;
        const float xs = x_scale[m];
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int n = n0 + 8 * e2;
          if (n >= N) continue;
          const float v = rescale(acc[4 * j + 2 * e2 + e1], xs, ws[e2], 0.f,
                                  false, kNone);
          const size_t o = (size_t)m * N + n;
          if constexpr (OUT_F32)
            static_cast<float*>(out)[o] = v;
          else
            static_cast<bf16*>(out)[o] = __float2bfloat16_rn(v);
        }
      }
  }
}

template <bool OUT_F32>
cudaError_t launch(const void* xq, const void* xs, const void* w,
                   const void* ws, void* out, int M, int N, int K,
                   cudaStream_t st) {
  auto kernel = int4_gemm_kernel<OUT_F32>;
  CUtensorMap tw, tx;
  const cuuint64_t dw[2] = {(cuuint64_t)(K / 2), (cuuint64_t)N};
  const cuuint64_t sw[1] = {(cuuint64_t)(K / 2)};
  const cuuint32_t bw[2] = {kChunk, kBW};
  // x as (M, 2, K/2): each half of a row ends where its columns do
  const cuuint64_t dx[3] = {(cuuint64_t)(K / 2), 2, (cuuint64_t)M};
  const cuuint64_t sx[2] = {(cuuint64_t)(K / 2), (cuuint64_t)K};
  const cuuint32_t bx[3] = {kChunk, 1, kBX};
  if (!encode_sw128(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, dw, sw, bw) ||
      !encode_sw128(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, xq, dx, sx, bx))
    return cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const int tiles_m = (M + kBX - 1) / kBX, tiles_n = (N + kBW - 1) / kBW;
  const int grid = min(sm_count(), tiles_m * tiles_n);
  kernel<<<grid, kThreads, kSmem, st>>>(
      tw, tx, static_cast<const float*>(xs), static_cast<const float*>(ws),
      out, M, N, K, tiles_m, tiles_n);
  return cudaGetLastError();
}

}  // namespace

// xq: (M, K) int8; xs: (M,) f32; w: (N, K/2) packed int4; ws: (N,) f32, all
// contiguous and 16-byte aligned; out: (M, N) bf16 (out_f32 = 0) or f32.
// K % 32 == 0. Returns the launch status (0 = launched).
extern "C" int ivlm_int4_gemm(const void* xq, const void* xs, const void* w,
                              const void* ws, void* out, int out_f32, int M,
                              int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = out_f32
                              ? launch<true>(xq, xs, w, ws, out, M, N, K, st)
                              : launch<false>(xq, xs, w, ws, out, M, N, K, st);
  return static_cast<int>(err);
}

IVLM_EXPORT_ERROR_STRING(ivlm_int4_gemm_sm90)
