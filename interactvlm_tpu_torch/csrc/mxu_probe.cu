// The tensor-core rate probe for Hopper (sm_90a): out = f32(sum over `loops`
// of x @ W^T), x (M, K), W (N, K), for four operand and accumulator types:
//   0  bf16 x bf16 -> f32      (mma.sync m16n8k16, f32 accumulators)
//   1  int8 x int8 -> int32    (mma.sync m16n8k32, int32 accumulators that
//                               wrap as two's complement)
//   2  int8 x int8 -> f32      (int32 products over each 128-element K
//                               chunk, each added to an f32 accumulator:
//                               Hopper's int8 tensor cores give int32 only;
//                               so K / 128 roundings a loop where the TPU
//                               kernel rounds once, the same sums while
//                               they stay below 2^24)
//   3  f32 x f32 -> f32        (fused multiply-adds on the CUDA cores: an
//                               f32 product, not TF32)
//
// Replaces the Pallas TPU kernel scripts/mxu_probe.py `_kernel`, which ran
// the dot `loops` times over x and W resident in VMEM to time the matrix
// unit with no HBM traffic. x (1.3 MB in bf16) and W (3.3 MB) do not fit in
// one SM's shared memory, so here each block owns a 64 x 64 output tile and
// walks K in 128-byte chunks: a chunk of x and of W is staged in shared
// memory once, and the block's share of the loops runs over it before the
// next chunk, so the operands cross from L2 once per block and the loops
// time the tensor cores fed from shared memory (ldmatrix fragments, as in a
// GEMM's mainloop). At the probe's 512 x 1280 x 1280 there are only 160
// tiles for 132 SMs, so the loops are split into `slices` over blocks
// (grid z) and the slices' sums are added into the zeroed output with
// atomics: 160 tiles x 33 slices = 40 blocks an SM. The TPU kernel's
// anti-hoisting trick (adding min(|acc|, 0) to x) is not needed: the mma is
// an asm volatile with a loop count known only at run time.
//
// What bounds it: the tensor cores (or, for f32, the CUDA cores) by
// construction: 2 M K N operations a loop over the peak rate.
#include "matmul_core.cuh"

namespace {

using namespace ivlm;

enum Combo { kBf16 = 0, kInt8 = 1, kInt8F32 = 2, kF32 = 3 };

constexpr int BM = 64, BN = 64, NTHREADS = 128;  // 4 warps of 32 x 32
constexpr int CHUNK = 128;                       // bytes of K a chunk

template <int C>
struct Elem {
  using T = bf16;
};
template <>
struct Elem<kInt8> {
  using T = int8_t;
};
template <>
struct Elem<kInt8F32> {
  using T = int8_t;
};
template <>
struct Elem<kF32> {
  using T = float;
};

__device__ __forceinline__ void loop_range(int loops, int& l0, int& l1) {
  const int z = blockIdx.z, S = gridDim.z;
  l0 = (int)((long long)loops * z / S);
  l1 = (int)((long long)loops * (z + 1) / S);
}

// tensor-core combos: 0, 1, 2
template <int C>
__global__ void __launch_bounds__(NTHREADS)
    mma_loop_kernel(const void* __restrict__ x, const void* __restrict__ w,
                    void* __restrict__ out, int M, int N, int K, int loops) {
  using T = typename Elem<C>::T;
  // 4 warps of 32 x 32, K in chunks of CHUNK bytes
  using TL = Tile<T, BM, BN, CHUNK / (int)sizeof(T), 2, 2, 1>;
  constexpr int KCH = TL::BK, LDS = TL::kLds;
  using Acc = typename TL::Acc;

  __shared__ __align__(16) T x_s[BM][LDS];
  __shared__ __align__(16) T w_s[BN][LDS];

  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wm = (warp / TL::WARPS_N) * TL::WTM;
  const int wn = (warp % TL::WARPS_N) * TL::WTN;
  int l0, l1;
  loop_range(loops, l0, l1);

  Acc acc[TL::MT][TL::NT][4];
  float accf[TL::MT][TL::NT][4];  // combo 2: the f32 sum of the int32 partials
  zero_acc(acc);
  zero_acc(accf);

  for (int c0 = 0; c0 < K; c0 += KCH) {
    __syncthreads();  // every warp is done with the previous chunk
    load_chunk<T, BM, KCH, LDS, NTHREADS>(x_s, xp, m0, M, c0, K, tid);
    load_chunk<T, BN, KCH, LDS, NTHREADS>(w_s, wp, n0, N, c0, K, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int l = l0; l < l1; ++l) {
      mma_chunk<TL>(acc, x_s, w_s, wm, wn, lane);
      if constexpr (C == kInt8F32) {
#pragma unroll
        for (int a = 0; a < TL::MT; ++a)
#pragma unroll
          for (int b = 0; b < TL::NT; ++b)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              accf[a][b][e] += __int2float_rn(acc[a][b][e]);
              acc[a][b][e] = 0;
            }
      }
    }
  }

  // the slices' sums are added into the zeroed output
  auto none = [](int) { return 0; };
  auto add = [&](int, int m, int n, auto v0, auto v1) {
    using V = decltype(v0);
    V* o = static_cast<V*>(out) + (size_t)m * N + n;
    atomicAdd(o, v0);
    atomicAdd(o + 1, v1);
  };
  if constexpr (C == kInt8F32) {
    for_each_pair<TL>(accf, m0, n0, M, N, none, add);
  } else {
    for_each_pair<TL>(acc, m0, n0, M, N, none, add);
  }
}

// f32 x f32 on the CUDA cores: each thread owns 4 rows x 8 columns of the
// 64 x 64 tile; the chunk is staged K-major so a k step reads three float4
__global__ void __launch_bounds__(NTHREADS)
    fma_loop_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, int M, int N, int K, int loops) {
  constexpr int KCH = CHUNK / 4;  // 32 floats
  constexpr int LD = BM + 4;      // padded K-major rows, 16-byte aligned
  __shared__ __align__(16) float x_s[KCH][LD];
  __shared__ __align__(16) float w_s[KCH][LD];

  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;  // rows 4 ty.., columns 4 tx.. and 32 + 4 tx..
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  int l0, l1;
  loop_range(loops, l0, l1);

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < K; c0 += KCH) {
    __syncthreads();
    for (int i = tid; i < BM * KCH / 4; i += NTHREADS) {
      const int r = i / (KCH / 4), k = (i % (KCH / 4)) * 4;
      const float4 a = *reinterpret_cast<const float4*>(x + (size_t)(m0 + r) * K + c0 + k);
      const float4 b = *reinterpret_cast<const float4*>(w + (size_t)(n0 + r) * K + c0 + k);
      x_s[k][r] = a.x, x_s[k + 1][r] = a.y, x_s[k + 2][r] = a.z, x_s[k + 3][r] = a.w;
      w_s[k][r] = b.x, w_s[k + 1][r] = b.y, w_s[k + 2][r] = b.z, w_s[k + 3][r] = b.w;
    }
    __syncthreads();
    for (int l = l0; l < l1; ++l) {
#pragma unroll 8
      for (int k = 0; k < KCH; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&x_s[k][ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&w_s[k][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&w_s[k][32 + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = (j < 4 ? tx * 4 + j : 32 + tx * 4 + j - 4);
      atomicAdd(out + (size_t)(m0 + ty * 4 + i) * N + n0 + col, acc[i][j]);
    }
}

}  // namespace

// x: (M, K), w: (N, K), both of the combo's input type, contiguous and
// 16-byte aligned; out: (M, N) f32 (int32 for combo 1), zero on entry.
// M % 64 == 0, N % 64 == 0, K a multiple of 128 bytes of the input type.
// `slices` splits the loops over the grid's z dimension. Returns the launch
// status (0 = launched).
extern "C" int ivlm_mxu_loop(const void* x, const void* w, void* out, int combo,
                             int M, int N, int K, int loops, int slices,
                             void* stream) {
  const int elem = combo == kBf16 ? 2 : combo == kF32 ? 4 : 1;
  if (combo < 0 || combo > 3 || M <= 0 || N <= 0 || K <= 0 || M % BM != 0 ||
      N % BN != 0 || (K * elem) % CHUNK != 0 || loops < 0 || slices < 1 ||
      slices > 65535 || M / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(N / BN, M / BM, slices);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (combo) {
    case kBf16:
      mma_loop_kernel<kBf16><<<grid, NTHREADS, 0, st>>>(x, w, out, M, N, K, loops);
      break;
    case kInt8:
      mma_loop_kernel<kInt8><<<grid, NTHREADS, 0, st>>>(x, w, out, M, N, K, loops);
      break;
    case kInt8F32:
      mma_loop_kernel<kInt8F32><<<grid, NTHREADS, 0, st>>>(x, w, out, M, N, K, loops);
      break;
    default:
      fma_loop_kernel<<<grid, NTHREADS, 0, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<float*>(out), M, N, K, loops);
  }
  return static_cast<int>(cudaGetLastError());
}

IVLM_EXPORT_ERROR_STRING(ivlm_mxu_probe)
