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
// What bounds it on the H100, at the main path's shapes:
// - the SAM ViT-H encoder (M = 131 072 or 156 800 rows, K x N = 1280 x 3840,
//   1280 x 1280, 1280 x 5120, 5120 x 1280): 2 M K N int8 operations against
//   2 M K + K N + 2 M N bytes, 640-1020 operations a byte, above the card's
//   ~590 int8 operations a byte: the tensor cores bound it, and the
//   in-kernel quantization of x competes with them for instruction slots;
// - LLaMA-7B prefill (M = 2552, ~1460 operations a byte): operations too;
// - LLaMA-7B decode and lm_head (M = 8 or 32): the int8 weight bytes, read
//   once per step.
// The TPU kernel kept the whole (K, N) weight resident in VMEM and swept row
// blocks in order. Here the output is tiled instead, and blocks run in
// parallel: each block first takes the absmax of its BM rows of x in one
// pass, then streams K in BK-wide chunks, quantizing the x chunk into shared
// memory as int8 (registers prefetch the next chunk during the products; the
// second read of x mostly hits L2, as all column blocks of a row block run
// next to each other) while W chunks arrive through a cp.async ring. The
// products run on mma.sync m16n8k32 s8 with fragments from ldmatrix; the
// int32 accumulators stay in registers and are rescaled once. Rows past M and
// columns past N are masked in-kernel (no host padding). Two tilings: 64 x
// 128 blocks of 8 warps for many rows, and 32 x 32 blocks of 4 warps with a
// 4-deep weight ring for decode, where only the count of blocks in flight
// (N / 32 of them) keeps enough weight bytes moving.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

enum Act { kNone = 0, kGelu = 1, kGeluTanh = 2 };

struct Epilogue {
  const float* w_scale;
  const float* bias;  // null: no bias
  void* out;
  int out_f32;
  int act;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 bytes read: the 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const int8_t* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of x: 8 bf16 or 4 f32 values, element i of the vector in order.
template <typename TX>
struct XVec;

template <>
struct XVec<bf16> {
  static constexpr int kN = 8;
  __device__ static __forceinline__ float get(const uint4& u, int i) {
    const uint32_t w = (&u.x)[i >> 1];
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <>
struct XVec<float> {
  static constexpr int kN = 4;
  __device__ static __forceinline__ float get(const uint4& u, int i) {
    return __uint_as_float((&u.x)[i]);
  }
};

__device__ __forceinline__ uint32_t quant4(float a, float b, float c, float d,
                                           float inv) {
  // rint (half to even), then clip: |x * inv| <= 127 up to one rounding, so
  // the clip only guards; never roundf, which rounds half away from zero
  const int qa = max(-127, min(127, __float2int_rn(__fmul_rn(a, inv))));
  const int qb = max(-127, min(127, __float2int_rn(__fmul_rn(b, inv))));
  const int qc = max(-127, min(127, __float2int_rn(__fmul_rn(c, inv))));
  const int qd = max(-127, min(127, __float2int_rn(__fmul_rn(d, inv))));
  return (uint32_t(qa) & 0xffu) | ((uint32_t(qb) & 0xffu) << 8) |
         ((uint32_t(qc) & 0xffu) << 16) | ((uint32_t(qd) & 0xffu) << 24);
}

__device__ __forceinline__ float rescale(int acc, float xs, float ws, float b,
                                         bool has_bias, int act) {
  // the order of the TPU kernel: (acc * x_scale) * w_scale, + bias, GELU,
  // each rounded on its own (no contraction into an fma)
  float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
  if (has_bias) v = __fadd_rn(v, b);
  if (act == kGelu) {
    v = 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
  } else if (act == kGeluTanh) {
    const float inner = 0.79788456080286536f * (v + 0.044715f * v * v * v);
    v = 0.5f * v * (1.0f + tanhf(inner));
  }
  return v;
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES,
          typename TX>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32)
    int8_matmul_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                       Epilogue ep, int M, int N, int K) {
  constexpr int NTHREADS = WARPS_M * WARPS_N * 32;
  constexpr int NWARPS = WARPS_M * WARPS_N;
  constexpr int LDS = BK + 16;  // padded row: ldmatrix rows hit distinct banks
  constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  constexpr int VEC = XVec<TX>::kN;
  constexpr int XV = BM * BK / VEC / NTHREADS;  // x vectors a thread loads
  constexpr int WV = BN * BK / 16 / NTHREADS;   // 16-byte W pieces a thread
  static_assert(MT >= 1 && NT % 2 == 0 && BM % (16 * WARPS_M) == 0, "tile");
  static_assert(XV >= 1 && XV * VEC * NTHREADS == BM * BK, "x chunk");
  static_assert(WV >= 1 && WV * 16 * NTHREADS == BN * BK, "w chunk");
  static_assert(BM % NWARPS == 0 && BK % 32 == 0, "rows, depth");

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
      for (int v = lane; v < K / VEC; v += 32) {
        const uint4 u = row[v];
#pragma unroll
        for (int e = 0; e < VEC; ++e) amax = fmaxf(amax, fabsf(XVec<TX>::get(u, e)));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (lane == 0) {
      const float a = fmaxf(amax, 1e-8f);
      inv_s[r] = __fdiv_rn(127.0f, a);
      xs_s[r] = __fdiv_rn(a, 127.0f);
    }
  }

  auto load_w = [&](int slot, int c) {
#pragma unroll
    for (int i = 0; i < WV; ++i) {
      const int t = tid + i * NTHREADS;
      const int n = t / (BK / 16), kp = (t % (BK / 16)) * 16;
      const int gn = n0 + n, gk = c * BK + kp;
      const bool ok = gn < N && gk < K;
      cp_async16(&w_s[slot][n][kp], ok ? w + (size_t)gn * K + gk : w, ok);
    }
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
      const float inv = inv_s[r];
      using G = XVec<TX>;
      if constexpr (VEC == 8) {
        uint2 q;
        q.x = quant4(G::get(xr[i], 0), G::get(xr[i], 1), G::get(xr[i], 2),
                     G::get(xr[i], 3), inv);
        q.y = quant4(G::get(xr[i], 4), G::get(xr[i], 5), G::get(xr[i], 6),
                     G::get(xr[i], 7), inv);
        *reinterpret_cast<uint2*>(&xq_s[buf][r][kv]) = q;
      } else {
        *reinterpret_cast<uint32_t*>(&xq_s[buf][r][kv]) =
            quant4(G::get(xr[i], 0), G::get(xr[i], 1), G::get(xr[i], 2),
                   G::get(xr[i], 3), inv);
      }
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NT; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0;

  const int wm = (warp / WARPS_N) * WTM, wn = (warp % WARPS_N) * WTN;
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

    const int8_t(*xa)[LDS] = xq_s[c & 1];
    const int8_t(*wb)[LDS] = w_s[c % STAGES];
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wm + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4(a[mt], &xa[r][ks * 32 + (lane >> 4) * 16]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        const int n = wn + nt * 8 + (lane & 7) + (lane >> 4) * 8;
        uint32_t r4[4];
        ldsm_x4(r4, &wb[n][ks * 32 + ((lane >> 3) & 1) * 16]);
        b[nt][0] = r4[0];
        b[nt][1] = r4[1];
        b[nt + 1][0] = r4[2];
        b[nt + 1][1] = r4[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
    if (c + 1 < nchunks) store_xq((c + 1) & 1, xr);
  }
  cp_async_wait<0>();

  // epilogue: accumulator element e of tile (mt, nt) sits at row
  // g + 8 * (e / 2), column 2 * (lane % 4) + e % 2 of the 16 x 8 tile
  const int g = lane >> 2, tig = lane & 3;
  const bool has_bias = ep.bias != nullptr;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n0 + wn + nt * 8 + tig * 2;
    if (n >= N) continue;  // N % 8 == 0: a tile is all in or all out
    const float w0 = ep.w_scale[n], w1 = ep.w_scale[n + 1];
    const float b0 = has_bias ? ep.bias[n] : 0.f;
    const float b1 = has_bias ? ep.bias[n + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + mt * 16 + g + h * 8;
        if (m0 + r >= M) continue;
        const float xs = xs_s[r];
        const float v0 = rescale(acc[mt][nt][2 * h], xs, w0, b0, has_bias, ep.act);
        const float v1 = rescale(acc[mt][nt][2 * h + 1], xs, w1, b1, has_bias, ep.act);
        const size_t o = (size_t)(m0 + r) * N + n;
        if (ep.out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(ep.out) + o) =
              make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(ep.out) + o) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// many rows: 64 x 128 output tiles, 8 warps of 32 x 32, 3-deep weight ring
constexpr int kLargeBM = 64, kLargeBN = 128;
// decode: 32 x 32 tiles, 4 warps of 16 x 16, 4-deep weight ring
constexpr int kSmallBM = 32, kSmallBN = 32;
constexpr int kSmallMaxRows = 32;

template <typename TX>
cudaError_t launch(const void* x, const void* w, const Epilogue& ep, int M,
                   int N, int K, cudaStream_t st) {
  const TX* xp = static_cast<const TX*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  if (M <= kSmallMaxRows) {
    const dim3 grid((N + kSmallBN - 1) / kSmallBN, (M + kSmallBM - 1) / kSmallBM);
    int8_matmul_kernel<kSmallBM, kSmallBN, 128, 2, 2, 4, TX>
        <<<grid, 128, 0, st>>>(xp, wp, ep, M, N, K);
  } else {
    const int row_blocks = (M + kLargeBM - 1) / kLargeBM;
    if (row_blocks > 65535) return cudaErrorInvalidValue;
    const dim3 grid((N + kLargeBN - 1) / kLargeBN, row_blocks);
    int8_matmul_kernel<kLargeBM, kLargeBN, 64, 2, 4, 3, TX>
        <<<grid, 256, 0, st>>>(xp, wp, ep, M, N, K);
  }
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

extern "C" const char* ivlm_int8_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
