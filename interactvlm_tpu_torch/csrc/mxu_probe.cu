// The tensor-core rate probe for Hopper (sm_90a): out = f32(sum over `loops`
// of x @ W^T), x (M, K), W (N, K), for four operand and accumulator types:
//   0  bf16 x bf16 -> f32      (wgmma m64n256k16, f32 accumulators)
//   1  int8 x int8 -> int32    (wgmma m64n256k32, int32 accumulators that
//                               wrap as two's complement)
//   2  int8 x int8 -> f32      (wgmma m64n128k32: int32 products over each
//                               128-element K chunk, each added to an f32
//                               accumulator: Hopper's int8 tensor cores give
//                               int32 only; so K / 128 roundings a loop
//                               where the TPU kernel rounds once, the same
//                               sums while they stay below 2^24)
//   3  f32 x f32 -> f32        (fused multiply-adds on the CUDA cores: an
//                               f32 product, not TF32)
//
// Replaces the Pallas TPU kernel scripts/mxu_probe.py `_kernel`, which ran
// the dot `loops` times over x and W resident in VMEM to time the matrix
// unit with no HBM traffic. x (1.3 MB in bf16) and W (3.3 MB) do not fit in
// one SM's shared memory, so here each block owns an output tile and walks
// K in 128-byte chunks: TMA stages a chunk of x and of W once, 128-byte
// swizzled, the next chunk landing while the block's share of the loops
// runs over this one, so the operands cross from L2 once per block and the
// loops time the tensor cores fed from shared memory. The accumulators stay
// in registers across the loops and chunks.
//
// What bounds it: the tensor cores (or, for f32, the CUDA cores) by
// construction: 2 M K N operations a loop over the peak rate. The wgmma
// combinations take 128 x 256 tiles (two warpgroups of 64 rows; 128 x 128
// for combination 2, whose f32 sums and two int32 sets must fit beside
// each other in registers): the widest product a warpgroup issues, so the
// tensor cores, not the issue of products or shared memory's bandwidth,
// set the pace. At the probe's 512 x 1280 x 1280 that is 20 tiles (40 for
// combination 2) for 132 SMs, so the loops are split into `slices` over
// blocks (grid z; ops/mxu.py:loop_slices makes tiles x slices a multiple
// of the SM count) and the slices' sums are added into the zeroed output
// with atomics. In combination 2 each loop's chunk product goes to one of
// two int32 sets in turn: the other set's conversion and f32 add run under
// this loop's products, and the conversion is exact integer arithmetic
// (the int32 sum, below 2^21 in magnitude, added into the mantissa of
// 1.5 * 2^23) where the int-to-float instruction runs at a quarter of the
// f32 rate. The TPU kernel's anti-hoisting trick (adding min(|acc|, 0) to
// x) is not needed: the products are asm volatile with a loop count known
// only at run time.
#include <type_traits>

#include "matmul_core.cuh"
#include "sm90_core.cuh"

namespace {

using namespace ivlm;
using namespace ivlm::sm90;

enum Combo { kBf16 = 0, kInt8 = 1, kInt8F32 = 2, kF32 = 3 };

constexpr int BM = 64, BN = 64, NTHREADS = 128;  // the f32 kernel's tile
constexpr int CHUNK = 128;                       // bytes of K a chunk
constexpr int WM = 128, kWThreads = 256;  // the wgmma kernel: 2 x 64 rows

__device__ __forceinline__ void loop_range(int loops, int& l0, int& l1) {
  const int z = blockIdx.z, S = gridDim.z;
  l0 = (int)((long long)loops * z / S);
  l1 = (int)((long long)loops * (z + 1) / S);
}

// The chunk's product for this warpgroup: four k steps of 32 bytes.
template <int C, int N, typename Acc>
__device__ __forceinline__ void chunk_product(Acc (&d)[N / 2], uint64_t dx,
                                              uint64_t dw, int first) {
#pragma unroll
  for (int kk = 0; kk < CHUNK / 32; ++kk) {
    const uint64_t a = desc_at(dx, kk * 32), b = desc_at(dw, kk * 32);
    const int scale_d = kk > 0 || !first;
    if constexpr (C == kBf16)
      wgmma_bf16_ss_n256(d, a, b, scale_d);
    else if constexpr (N == 256)
      wgmma_s8_n256(d, a, b, scale_d);
    else
      wgmma_s8_n128(d, a, b, scale_d);
  }
}

// f += the int32 chunk sums d, exactly for |d| < 2^22: d + 0x4B400000 is
// the float 1.5 * 2^23 + d, and subtracting 1.5 * 2^23 leaves d.
template <int N>
__device__ __forceinline__ void add_exact(float (&f)[N], const int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    f[i] += __int_as_float(d[i] + 0x4B400000) - 12582912.f;
}

// TMA: chunk c of x's and W's tiles into buffer c % 2
template <int kX, int kBuf, int kElems>
__device__ __forceinline__ void load_chunk_tma(unsigned char* smem,
                                               uint64_t* full,
                                               const CUtensorMap* tx,
                                               const CUtensorMap* tw, int c,
                                               int m0, int n0) {
  uint64_t* bar = &full[c & 1];
  unsigned char* dst = smem + (c & 1) * kBuf;
  mbar_arrive_expect_tx(bar, kBuf);
  tma_load_2d(dst, tx, bar, c * kElems, m0);
  tma_load_2d(dst + kX, tw, bar, c * kElems, n0);
}

// tensor-core combos 0, 1 (N = 256) and 2 (N = 128)
template <int C, int N>
__global__ void __launch_bounds__(kWThreads, 1)
    wgmma_loop_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tw,
                      void* __restrict__ out, int M, int Nout, int K,
                      int loops) {
  using Acc = typename std::conditional<C == kBf16, float, int>::type;
  constexpr int kX = WM * CHUNK, kW = N * CHUNK, kBuf = kX + kW;
  constexpr int kElems = C == kBf16 ? CHUNK / 2 : CHUNK;  // K a chunk
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * kBuf);
  const int wg = threadIdx.x / 128;
  const int n0 = blockIdx.x * N, m0 = blockIdx.y * WM;
  int l0, l1;
  loop_range(loops, l0, l1);
  if (l0 == l1) return;  // this slice adds nothing
  const int nchunks = K / kElems;
  if (threadIdx.x == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    load_chunk_tma<kX, kBuf, kElems>(smem, full, &tx, &tw, 0, m0, n0);

  Acc acc[N / 2];      // combos 0, 1: the sums; combo 2: int32 set a
  int acc2[N / 2];     // combo 2: int32 set b
  float accf[N / 2];   // combo 2: the f32 sums
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    acc[i] = 0;
    acc2[i] = 0;
    accf[i] = 0.f;
  }
  for (int c = 0; c < nchunks; ++c) {
    // the other buffer's chunk was finished by both warpgroups before the
    // barrier that ended the last chunk
    if (threadIdx.x == 0 && c + 1 < nchunks)
      load_chunk_tma<kX, kBuf, kElems>(smem, full, &tx, &tw, c + 1, m0, n0);
    mbar_wait(&full[c & 1], (c >> 1) & 1);
    const uint32_t base = smem_addr(smem + (c & 1) * kBuf);
    const uint64_t dx = desc_kmajor(base + wg * 64 * CHUNK);
    const uint64_t dw = desc_kmajor(base + kX);
    if constexpr (C != kInt8F32) {
      wgmma_fence();
      for (int l = l0; l < l1; ++l) {
        chunk_product<C, N>(acc, dx, dw, 0);
        wgmma_commit();
        wgmma_wait<1>();
      }
      wgmma_wait<0>();
      fence_regs(acc);
    } else {
      // loop l's product into set a (even l - l0) or b; the other set,
      // the loop before's, is added into accf while it runs. Unrolled by
      // two, so each set keeps its registers.
      wgmma_fence();
      chunk_product<C, N>(acc, dx, dw, 1);
      wgmma_commit();
      int l = l0 + 1;
      for (; l + 1 < l1; l += 2) {
        wgmma_fence();
        chunk_product<C, N>(acc2, dx, dw, 1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(acc);
        add_exact(accf, acc);
        wgmma_fence();
        chunk_product<C, N>(acc, dx, dw, 1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(acc2);
        add_exact(accf, acc2);
      }
      if (l < l1) {  // the last loop, into b
        wgmma_fence();
        chunk_product<C, N>(acc2, dx, dw, 1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(acc);
        add_exact(accf, acc);
        wgmma_wait<0>();
        fence_regs(acc2);
        add_exact(accf, acc2);
      } else {
        wgmma_wait<0>();
        fence_regs(acc);
        add_exact(accf, acc);
      }
    }
    __syncthreads();  // both warpgroups are done with this buffer
  }

  // the slices' sums are added into the zeroed output: element 4 j + e of
  // a thread sits at row 16 warp + g + 8 (e / 2), column 8 j + 2 t + e % 2
  const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31;
  const int r0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int c0 = n0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e >> 1), col = c0 + 8 * j + (e & 1);
      if (r >= M || col >= Nout) continue;
      const size_t i = (size_t)r * Nout + col;
      if constexpr (C == kInt8F32)
        atomicAdd(static_cast<float*>(out) + i, accf[4 * j + e]);
      else
        atomicAdd(static_cast<Acc*>(out) + i, acc[4 * j + e]);
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


template <int C, int N>
cudaError_t launch_wgmma(const void* x, const void* w, void* out, int M,
                         int Nout, int K, int loops, int slices,
                         cudaStream_t st) {
  const int elem = C == kBf16 ? 2 : 1;
  const CUtensorMapDataType t = C == kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint64_t dx[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t dw[2] = {(cuuint64_t)K, (cuuint64_t)Nout};
  const cuuint64_t stride[1] = {(cuuint64_t)K * elem};
  const cuuint32_t bx[2] = {(cuuint32_t)(CHUNK / elem), WM};
  const cuuint32_t bw[2] = {(cuuint32_t)(CHUNK / elem), N};
  CUtensorMap tx, tw;
  if (!encode_sw128(&tx, t, 2, x, dx, stride, bx) ||
      !encode_sw128(&tw, t, 2, w, dw, stride, bw))
    return cudaErrorInvalidValue;
  constexpr int kSmem = 1024 + 2 * (WM + N) * CHUNK + 16;
  const auto kernel = wgmma_loop_kernel<C, N>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Nout + N - 1) / N, (M + WM - 1) / WM, slices);
  kernel<<<grid, kWThreads, kSmem, st>>>(tx, tw, out, M, Nout, K, loops);
  return cudaGetLastError();
}

}  // namespace

// x: (M, K), w: (N, K), both of the combo's input type, contiguous and
// 16-byte aligned; out: (M, N) f32 (int32 for combo 1), zero on entry.
// K a multiple of 128 bytes of the input type; combo 3 (f32) also M % 64
// == 0 and N % 64 == 0, the wgmma combos any M and N (tiles of 128 x 256,
// 128 x 128 for combo 2, zero-filled past the edge). `slices` splits the
// loops over the grid's z dimension. Returns the launch status
// (0 = launched).
extern "C" int ivlm_mxu_loop(const void* x, const void* w, void* out, int combo,
                             int M, int N, int K, int loops, int slices,
                             void* stream) {
  const int elem = combo == kBf16 ? 2 : combo == kF32 ? 4 : 1;
  if (combo < 0 || combo > 3 || M <= 0 || N <= 0 || K <= 0 ||
      (K * elem) % CHUNK != 0 || loops < 0 || slices < 1 ||
      slices > 65535 || (M + BM - 1) / BM > 65535 ||
      (combo == kF32 && (M % BM != 0 || N % BN != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (combo) {
    case kBf16:
      return static_cast<int>(
          launch_wgmma<kBf16, 256>(x, w, out, M, N, K, loops, slices, st));
    case kInt8:
      return static_cast<int>(
          launch_wgmma<kInt8, 256>(x, w, out, M, N, K, loops, slices, st));
    case kInt8F32:
      return static_cast<int>(
          launch_wgmma<kInt8F32, 128>(x, w, out, M, N, K, loops, slices, st));
    default: {
      const dim3 grid(N / BN, M / BM, slices);
      fma_loop_kernel<<<grid, NTHREADS, 0, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<float*>(out), M, N, K, loops);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

IVLM_EXPORT_ERROR_STRING(ivlm_mxu_probe)
