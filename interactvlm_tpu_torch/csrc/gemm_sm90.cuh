// The GEMM skeleton of the Hopper (sm_90a) matmul kernels: out (M, N) =
// epilogue(x (M, K) W (N, K)^T), both operands K-major, on wgmma fed by TMA.
// Used by the int8 GEMM (int8_gemm_sm90.cu: s8 operands, int32 sums, the
// int8 rescale) and the bf16 serving matmul (serving_matmul.cu: bf16
// operands, f32 sums, bias and GELU); an operand type `Op` gives the element
// type, the accumulator, the TMA data type and the product, an epilogue
// `Epi` turns a warp's accumulators into f32 output values in place. The int4
// GEMM (int4_gemm_sm90.cu), whose consumers split the packed weight into
// int8 tiles of their own, walks its tiles with tile_coords.
//
// - A CTA computes 128 x 256 tiles: two consumer warpgroups of 64 rows each
//   run wgmma m64n256 with both operands from shared memory, 128
//   accumulators a thread (256 columns took 1.314 ms at the SAM qkv shape
//   against 1.588 for 128 in the int8 GEMM on an H100 80GB HBM3 at 700 W,
//   PERF.md).
// - One producer thread keeps a ring of K chunks of 128 bytes (128 int8 or
//   64 bf16 values) full by TMA (128-byte swizzle, full/empty mbarriers),
//   with its warpgroup's registers given to the consumers by setmaxnreg.
//   A chunk is four products of 32 bytes of K whatever the type.
// - The grid is persistent, one CTA an SM, walking tiles in groups of 16
//   row blocks with the row block fastest, so a group's x rows and the W
//   columns it sweeps stay in L2 while the next tile's chunks load during
//   this tile's epilogue.
// - The epilogue runs from the accumulator registers, compiled for each
//   variant (a branch per element kept the column loads from being issued
//   together, and cost more than the products); each warp passes its rows
//   through a small shared-memory buffer so that lanes store whole 16-byte
//   pieces of 128-byte row segments, rows past M and columns past N masked.
//   TMA fills reads past M, N or K with zeros, so a ragged K chunk adds
//   nothing and no operand is padded on the host.
#pragma once

#include "sm90_core.cuh"

#include <type_traits>

namespace ivlm {
namespace gemm {

using namespace ivlm::sm90;

constexpr int kBM = 128;       // rows a tile: two consumer warpgroups of 64
constexpr int kBN = 256;       // columns a tile
constexpr int kChunk = 128;    // K bytes a stage: one 128-byte swizzle row
constexpr int kGroupM = 16;    // row blocks a raster group
constexpr int kThreads = 384;  // warpgroups 0, 1 consume; 2 produces
constexpr int kOutRow = 144;   // bytes a row of a warp's output buffer:
                               // 128 of data, 16 against bank conflicts
constexpr int kStages = 4;
constexpr int kABytes = kBM * kChunk;
constexpr int kBBytes = kBN * kChunk;
constexpr int kRing = kStages * (kABytes + kBBytes);
constexpr int kOut = 8 * 16 * kOutRow;  // a buffer a consumer warp
constexpr int kSmem = 1024 + kRing + kOut + 2 * kStages * 8;

// s8 x s8 -> s32, m64n256k32
struct S8 {
  using T = int8_t;
  using Acc = int;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  __device__ static __forceinline__ void mma(int (&d)[kBN / 2], uint64_t a,
                                             uint64_t b, int scale_d) {
    wgmma_s8_n256(d, a, b, scale_d);
  }
};

// bf16 x bf16 -> f32, m64n256k16
struct Bf16 {
  using T = __nv_bfloat16;
  using Acc = float;
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ static __forceinline__ void mma(float (&d)[kBN / 2], uint64_t a,
                                             uint64_t b, int scale_d) {
    wgmma_bf16_ss_n256(d, a, b, scale_d);
  }
};

__device__ __forceinline__ float as_f32(int v) { return __int_as_float(v); }
__device__ __forceinline__ float as_f32(float v) { return v; }

__device__ __forceinline__ void tile_coords(int t, int tiles_m, int tiles_n,
                                            int& tm, int& tn) {
  const int per_group = kGroupM * tiles_n;
  const int first = (t / per_group) * kGroupM;
  const int rows = min(kGroupM, tiles_m - first);
  const int local = t % per_group;
  tm = first + local % rows;
  tn = local / rows;
}

// The warp's 16 rows x 256 columns of the tile, already turned into f32
// values in the accumulator registers, to the output: 128 bytes of each row
// at a time, written into the warp's shared buffer in the accumulator
// layout and read back as 16-byte pieces of whole rows, which the lanes
// store.
template <bool OUT_F32, typename Acc>
__device__ __forceinline__ void store_tile(const Acc (&acc)[kBN / 2],
                                           void* out, unsigned char* buf,
                                           int row0, int n0, int M, int N) {
  using T = typename std::conditional<OUT_F32, float, __nv_bfloat16>::type;
  constexpr int E = (int)sizeof(T);
  constexpr int CH = 128 / E;  // columns a 128-byte row segment
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int c = 0; c < kBN / CH; ++c) {
#pragma unroll
    for (int jj = 0; jj < CH / 8; ++jj) {
      const int j = c * (CH / 8) + jj;
      unsigned char* p = buf + g * kOutRow + (jj * 8 + tig * 2) * E;
      const float v0 = as_f32(acc[4 * j]), v1 = as_f32(acc[4 * j + 1]);
      const float v2 = as_f32(acc[4 * j + 2]), v3 = as_f32(acc[4 * j + 3]);
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
        *reinterpret_cast<uint4*>(static_cast<T*>(out) + (size_t)m * N + n) = v;
    }
    __syncwarp();
  }
}

// The body of a GEMM kernel (each library's __global__ wrapper calls it,
// so the kernels keep their own names in a profile). Epi::apply(acc, row0,
// n0, M, N) turns the warp's accumulators (rows row0.., columns n0..) into
// f32 values in place; Epi::kOutF32 and Epi::out name the output.
template <class Op, class Epi>
__device__ __forceinline__ void gemm_body(const CUtensorMap& tx,
                                          const CUtensorMap& tw, const Epi& ep,
                                          int M, int N, int K, int tiles_m,
                                          int tiles_n) {
  constexpr int S = kStages;
  constexpr int kBK = kChunk / (int)sizeof(typename Op::T);  // K a chunk
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* a_ring = smem;                // S x (128 x 128 bytes)
  unsigned char* b_ring = smem + S * kABytes;  // S x (256 x 128 bytes)
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
    typename Op::Acc acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      int tm, tn;
      tile_coords(t, tiles_m, tiles_n, tm, tn);
      int prev = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint32_t a = smem_addr(a_ring + stage * kABytes) + wg * 64 * kChunk;
        const uint32_t b = smem_addr(b_ring + stage * kBBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kChunk / 32; ++kk)
          Op::mma(acc, desc_kmajor(a + kk * 32), desc_kmajor(b + kk * 32),
                  (kb > 0 || kk > 0) ? 1 : 0);
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
      const int row0 = tm * kBM + warp * 16, n0 = tn * kBN;
      ep.apply(acc, row0, n0, M, N);
      store_tile<Epi::kOutF32>(acc, ep.out, buf, row0, n0, M, N);
    }
  }
}

// Encodes the two operands' tensor maps (128-byte boxes along K, 128 rows of
// x and 256 of W) and launches `kernel` persistent, one CTA an SM at most.
template <class Op, class Epi, class Kernel>
cudaError_t launch(Kernel kernel, const void* x, const void* w, const Epi& ep,
                   int M, int N, int K, cudaStream_t st) {
  constexpr int E = (int)sizeof(typename Op::T);
  CUtensorMap tx, tw;
  const cuuint64_t dx[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t dw[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t stride[1] = {(cuuint64_t)K * E};
  const cuuint32_t bx[2] = {kChunk / E, kBM}, bw[2] = {kChunk / E, kBN};
  if (!encode_sw128(&tx, Op::kType, 2, x, dx, stride, bx) ||
      !encode_sw128(&tw, Op::kType, 2, w, dw, stride, bw))
    return cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const int tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + kBN - 1) / kBN;
  const int grid = min(sm_count(), tiles_m * tiles_n);
  kernel<<<grid, kThreads, kSmem, st>>>(tx, tw, ep, M, N, K, tiles_m, tiles_n);
  return cudaGetLastError();
}

}  // namespace gemm
}  // namespace ivlm
