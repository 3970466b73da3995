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
// quantizes x * rf), taken above the decode kernel's 32 rows (LLaMA-7B
// prefill) and by the row-parallel int4 linear at every row count. It
// replaces no Pallas kernel: the JAX package leaves the int4 product to
// XLA's fusion of the unpack into its two half-K dots
// (interactvlm_tpu/ops/quant.py:int4_matmul).
//
// What bounds it on the H100: at LLaMA-7B prefill (M = 2552, K x N = 4096 x
// 4096, 4096 x 11008, 11008 x 4096) the int8 operations, 2 M K N against
// M K + N K / 2 + 2 M N bytes. s8 wgmma reads B from shared memory only,
// and a weight unpacked into the consumers' registers (A) made each
// chunk's unpack wait for the last chunk's products. So the weight is
// split into int8 tiles in shared memory and the consumers run the int8
// GEMM's products (gemm_sm90.cuh: two warpgroups of wgmma m64n256k32 s8,
// both operands K-major and 128-byte swizzled, 128 accumulators a thread):
// - a stage is one K half of one packed chunk (128 bytes a weight row, 256
//   K values): the weight's low or high nibbles as an int8 tile and x's
//   columns [128 i, 128 i + 128) or K/2 plus those (x seen as (M, 2, K/2),
//   so that each half's edge fills zeros);
// - the weight is wgmma's A (64 rows a warpgroup, 128 a tile) and x its B
//   (256 rows a tile), so a packed tile is 16 KB and its split 16 KB a
//   stage; with x as A the packed tile (256 rows) and its split take
//   twice that, and the rings with the output buffer outgrow a block's
//   227 KB;
// - warp 8 keeps two rings full by TMA: x's half tiles (4 x 32 KB, three
//   stages ahead, as in the int8 GEMM) and the packed tiles (2 x 16 KB);
// - each consumer warpgroup splits its own 64 weight rows of stage k + 1
//   into a ring of 2 split tiles while its products of stage k run: the
//   swizzled place of a byte in the packed tile is its place in the int8
//   tile, so a thread reads 16 bytes and writes their 16 low or high
//   nibbles, sign-extended bytewise (matmul_core.cuh unpack_nibbles), at
//   the same offset, then fences them for wgmma. No other warp waits on a
//   split, and a split slot is rewritten only after its products are done
//   (a split by a producer warpgroup, handed over by barriers, put its
//   latency in the consumers' way);
// - the grid is persistent, one CTA an SM, walking 128 x 256 tiles in
//   groups of 16 weight-row blocks (gemm_sm90.cuh tile_coords), the next
//   tile's loads running under this tile's epilogue;
// - the epilogue rescales each accumulator in the int8 kernels' order
//   (matmul_core.cuh rescale, no bias, no activation) and, since a warp's
//   accumulators are 16 output columns of 256 rows, passes 32 rows at a time
//   through a small shared buffer so that lanes store 16-byte pieces of
//   each row; rows past M and columns past N masked. TMA fills reads past
//   M, N or K with zeros, and a zero byte splits into two zero weights, so
//   no operand is padded.
#include "gemm_sm90.cuh"
#include "matmul_core.cuh"

namespace {

using namespace ivlm;
using namespace ivlm::sm90;

constexpr int kBW = 128;       // weight rows (output columns) a tile
constexpr int kBX = 256;       // x rows a tile
constexpr int kChunk = 128;    // packed bytes a weight row a chunk
constexpr int kThreads = 384;  // warpgroups 0, 1 consume; warp 8 loads
constexpr int kXS = 4, kWS = 2, kPS = 2;  // x, split and packed stages
constexpr int kXBytes = kBX * kChunk;     // an x half tile: 32 KB
constexpr int kWBytes = kBW * kChunk;     // a split or packed tile: 16 KB
constexpr int kBufRow = 20;               // floats a row of a warp's buffer:
                                          // 16 columns, 4 against conflicts
constexpr int kBuf = 32 * kBufRow * 4;    // 32 rows a warp
constexpr int kOffW = kXS * kXBytes;
constexpr int kOffP = kOffW + kWS * kWBytes;
constexpr int kOffBuf = kOffP + kPS * kWBytes;
constexpr int kOffBar = kOffBuf + 8 * kBuf;
constexpr int kBars = 2 * (kXS + kPS);
constexpr int kSmem = 1024 + kOffBar + kBars * 8;

// The 16 bytes of packed weight at v, split into K half h's 16 int8 values.
__device__ __forceinline__ uint4 split_half(const uint4 v, int h) {
  uint4 l, u;
  unpack_nibbles(v.x, l.x, u.x);
  unpack_nibbles(v.y, l.y, u.y);
  unpack_nibbles(v.z, l.z, u.z);
  unpack_nibbles(v.w, l.w, u.w);
  return h ? u : l;
}

// a and b rounded to bf16, a in the low half
__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <bool OUT_F32>
__global__ void __launch_bounds__(kThreads, 1)
    int4_gemm_kernel(const __grid_constant__ CUtensorMap tw,
                     const __grid_constant__ CUtensorMap tx,
                     const float* __restrict__ x_scale,
                     const float* __restrict__ w_scale, void* __restrict__ out,
                     int M, int N, int K, int tiles_w, int tiles_x) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* x_ring = smem;
  unsigned char* w_ring = smem + kOffW;  // the split tiles
  unsigned char* p_ring = smem + kOffP;  // the packed tiles
  uint64_t* x_full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* x_empty = x_full + kXS;
  uint64_t* p_full = x_empty + kXS;
  uint64_t* p_empty = p_full + kPS;

  const int npk = (K / 2 + kChunk - 1) / kChunk;  // packed chunks
  const int ntiles = tiles_w * tiles_x;
  // this CTA's chunks: npk for each of its tiles
  const int nq = ((ntiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                  (int)gridDim.x) * npk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kXS; ++s) {
      mbar_init(&x_full[s], 1);   // the loader's arrival with the bytes
      mbar_init(&x_empty[s], 2);  // one arrival a consumer warpgroup
    }
    for (int s = 0; s < kPS; ++s) {
      mbar_init(&p_full[s], 1);
      mbar_init(&p_empty[s], 256);  // each consumer's, after its reads
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- the loader: chunk q's packed tile, then its two x half tiles
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256)
      for (int q = 0; q < nq; ++q) {
        int tw_, tx_;
        gemm::tile_coords(blockIdx.x + (q / npk) * gridDim.x, tiles_w,
                          tiles_x, tw_, tx_);
        const int i = q % npk, ps = q % kPS;
        mbar_wait(&p_empty[ps], ((q / kPS) & 1) ^ 1);
        mbar_arrive_expect_tx(&p_full[ps], kWBytes);
        tma_load_2d(p_ring + ps * kWBytes, &tw, &p_full[ps], i * kChunk,
                    tw_ * kBW);
        for (int h = 0; h < 2; ++h) {
          const int k = 2 * q + h, xs = k % kXS;
          mbar_wait(&x_empty[xs], ((k / kXS) & 1) ^ 1);
          mbar_arrive_expect_tx(&x_full[xs], kXBytes);
          tma_load_3d(x_ring + xs * kXBytes, &tx, &x_full[xs], i * kChunk,
                      h, tx_ * kBX);
        }
      }
    return;
  }

  // ---- consumers: warpgroup wg owns weight rows 64 wg .. 64 wg + 63 of a
  // tile, all 256 x rows; warp w (0..7) rows 16 (w % 4) .. of those
  setmaxnreg_inc<232>();
  const int wg = warp >> 2, ct = threadIdx.x & 127;
  // Stage k = 2 q + h is K half h of packed chunk q. Its split: this
  // warpgroup's 64 rows of the packed tile, their low or high nibbles into
  // split slot k % kWS, whose last products (stage k - kWS) are done.
  auto split = [&](int k) {
    const int q = k >> 1, h = k & 1, ps = q % kPS;
    if (h == 0) mbar_wait(&p_full[ps], (q / kPS) & 1);
    const uint4* src =
        reinterpret_cast<const uint4*>(p_ring + ps * kWBytes) + wg * 512;
    uint4* dst =
        reinterpret_cast<uint4*>(w_ring + (k % kWS) * kWBytes) + wg * 512;
    uint4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = src[ct + 128 * j];
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[ct + 128 * j] = split_half(v[j], h);
    fence_proxy_async();  // this warpgroup's wgmma reads them
    if (h == 1) mbar_arrive(&p_empty[ps]);  // this thread's reads are done
  };
  int acc[kBX / 2];
  int k = 0, prev_x = 0;
  float* buf = reinterpret_cast<float*>(smem + kOffBuf + warp * kBuf);
  const int g = lane >> 2, t4 = lane & 3;
  if (nq > 0) split(0);
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    int tw_, tx_;
    gemm::tile_coords(t, tiles_w, tiles_x, tw_, tx_);
    for (int kb = 0; kb < 2 * npk; ++kb, ++k) {
      const int xs = k % kXS;
      mbar_wait(&x_full[xs], (k / kXS) & 1);
      bar_sync(1 + wg, 128);  // the warpgroup's split of stage k is in place
      const uint32_t a =
          smem_addr(w_ring + (k % kWS) * kWBytes) + wg * 64 * kChunk;
      const uint32_t b = smem_addr(x_ring + xs * kXBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 32; ++kk)
        wgmma_s8_n256(acc, desc_kmajor(a + kk * 32), desc_kmajor(b + kk * 32),
                      (kb > 0 || kk > 0) ? 1 : 0);
      wgmma_commit();
      if (kb > 0) {  // the previous stage's products are done: free it
        wgmma_wait<1>();
        if (ct == 0) mbar_arrive(&x_empty[prev_x]);
      }
      prev_x = xs;
      // the next stage's split runs under these products (a tile's first
      // stage follows the last tile's wait for all of its products)
      if (k + 1 < 2 * nq) split(k + 1);
    }
    wgmma_wait<0>();
    if (ct == 0) mbar_arrive(&x_empty[prev_x]);
    fence_regs(acc);
    // element 4 j + e: weight row n = n0 + g + 8 (e / 2), x row
    // m = m0 + 8 j + 2 t4 + e % 2; out[m, n]
    const int n0 = tw_ * kBW + 64 * wg + 16 * (warp & 3);
    const int m0 = tx_ * kBX;
    float wsc[2];
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2)
      wsc[e2] = n0 + g + 8 * e2 < N ? w_scale[n0 + g + 8 * e2] : 0.f;
#pragma unroll
    for (int grp = 0; grp < kBX / 32; ++grp) {
      // rows 32 grp .. 32 grp + 31 into the buffer as (row, column) f32
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int r = 8 * jj + 2 * t4 + e1, m = m0 + 32 * grp + r;
          const float xsc = m < M ? x_scale[m] : 0.f;
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2)
            buf[r * kBufRow + g + 8 * e2] =
                rescale(acc[4 * (4 * grp + jj) + 2 * e2 + e1], xsc, wsc[e2],
                        0.f, false, kNone);
        }
      __syncwarp();
      // 32 rows x 16 columns as 16-byte pieces: 8 bf16 or 4 f32 values
      constexpr int kPer = OUT_F32 ? 4 : 8;  // columns a piece
#pragma unroll
      for (int i = 0; i < 16 / kPer; ++i) {
        const int piece = lane + 32 * i;
        const int r = piece / (16 / kPer), c = (piece % (16 / kPer)) * kPer;
        const int m = m0 + 32 * grp + r, n = n0 + c;
        const float4* p = reinterpret_cast<const float4*>(buf + r * kBufRow + c);
        if (m < M && n < N) {  // N % 8 == 0: a piece is all in or all out
          if constexpr (OUT_F32) {
            *reinterpret_cast<float4*>(static_cast<float*>(out) +
                                       (size_t)m * N + n) = p[0];
          } else {
            const float4 v0 = p[0], v1 = p[1];
            *reinterpret_cast<uint4*>(static_cast<bf16*>(out) +
                                      (size_t)m * N + n) =
                make_uint4(bf16x2_bits(v0.x, v0.y), bf16x2_bits(v0.z, v0.w),
                           bf16x2_bits(v1.x, v1.y), bf16x2_bits(v1.z, v1.w));
          }
        }
      }
      __syncwarp();
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
  const int tiles_w = (N + kBW - 1) / kBW, tiles_x = (M + kBX - 1) / kBX;
  const int grid = min(sm_count(), tiles_w * tiles_x);
  kernel<<<grid, kThreads, kSmem, st>>>(
      tw, tx, static_cast<const float*>(xs), static_cast<const float*>(ws),
      out, M, N, K, tiles_w, tiles_x);
  return cudaGetLastError();
}

}  // namespace

// xq: (M, K) int8; xs: (M,) f32; w: (N, K/2) packed int4; ws: (N,) f32, all
// contiguous and 16-byte aligned; out: (M, N) bf16 (out_f32 = 0) or f32.
// K % 32 == 0, N % 8 == 0. Returns the launch status (0 = launched).
extern "C" int ivlm_int4_gemm(const void* xq, const void* xs, const void* w,
                              const void* ws, void* out, int out_f32, int M,
                              int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0 || N % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = out_f32
                              ? launch<true>(xq, xs, w, ws, out, M, N, K, st)
                              : launch<false>(xq, xs, w, ws, out, M, N, K, st);
  return static_cast<int>(err);
}

IVLM_EXPORT_ERROR_STRING(ivlm_int4_gemm_sm90)
