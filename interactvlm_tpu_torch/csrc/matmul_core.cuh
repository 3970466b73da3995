// Shared device code of the hand-written matmul kernels: cp.async copies
// into shared memory (the window probe's copy kernel), the per-row int8
// quantization, of x or of x times an int4 weight's row factor (the row
// quantize and the one-launch int8 / int4 matmul), the unpack of packed
// int4 nibbles (the int4 matmuls) and the epilogue arithmetic (rescale,
// GELU) of every int8, int4 and bf16 matmul kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ivlm {

using bf16 = __nv_bfloat16;

enum Act { kNone = 0, kGelu = 1, kGeluTanh = 2 };

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

// The largest |x| of a 16-byte vector: exact in f32 (|x| and max are exact
// in x's own type, and widening bf16 to f32 is exact). The vector is taken
// by value: a reference into global memory would be read a word at a time.
template <typename TX>
__device__ __forceinline__ float vec_amax(const uint4 u, float amax) {
#pragma unroll
  for (int e = 0; e < XVec<TX>::kN; ++e)
    amax = fmaxf(amax, fabsf(XVec<TX>::get(u, e)));
  return amax;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The per-row scales from the row's absmax, by IEEE division:
// inv = 127 / max(amax, 1e-8), x_scale = max(amax, 1e-8) / 127.
__device__ __forceinline__ void row_scales(float amax, float& inv,
                                           float& x_scale) {
  const float a = fmaxf(amax, 1e-8f);
  inv = __fdiv_rn(127.0f, a);
  x_scale = __fdiv_rn(a, 127.0f);
}

// rint (half to even) of |v| < 2^22: v + 1.5 2^23 rounds to an integer in
// f32 (half to even, as __float2int_rn), which sits in the low bits. Two
// full-rate instructions where the conversion runs at a quarter of the rate.
__device__ __forceinline__ int rint_small(float v) {
  return __float_as_int(__fadd_rn(v, 12582912.0f)) - 0x4B400000;
}

__device__ __forceinline__ uint32_t quant4(float a, float b, float c, float d,
                                           float inv) {
  // rint (half to even), then clip: |x * inv| <= 127 up to one rounding, so
  // the clip only guards; never roundf, which rounds half away from zero
  const int qa = max(-127, min(127, rint_small(__fmul_rn(a, inv))));
  const int qb = max(-127, min(127, rint_small(__fmul_rn(b, inv))));
  const int qc = max(-127, min(127, rint_small(__fmul_rn(c, inv))));
  const int qd = max(-127, min(127, rint_small(__fmul_rn(d, inv))));
  return (uint32_t(qa) & 0xffu) | ((uint32_t(qb) & 0xffu) << 8) |
         ((uint32_t(qc) & 0xffu) << 16) | ((uint32_t(qd) & 0xffu) << 24);
}

// One 16-byte vector of x quantized: 8 int8 values (bf16 x) as a uint2, or
// 4 (f32 x) in .x.
template <typename TX>
__device__ __forceinline__ uint2 quant_vec(const uint4 u, float inv) {
  using G = XVec<TX>;
  uint2 q;
  q.x = quant4(G::get(u, 0), G::get(u, 1), G::get(u, 2), G::get(u, 3), inv);
  if constexpr (G::kN == 8) {
    q.y = quant4(G::get(u, 4), G::get(u, 5), G::get(u, 6), G::get(u, 7), inv);
  } else {
    q.y = 0u;
  }
  return q;
}

// The f32 values of a 16-byte vector of x, each times its row factor (`rf`:
// the factors of the vector's K columns, 16-byte aligned), the product
// rounded once: what ops/quant.py's `x.float() * row_factor` gives.
template <typename TX>
__device__ __forceinline__ void vec_times(const uint4 u, const float* rf,
                                          float (&v)[XVec<TX>::kN]) {
#pragma unroll
  for (int q = 0; q < XVec<TX>::kN / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(rf)[q];
    v[4 * q] = __fmul_rn(XVec<TX>::get(u, 4 * q), f.x);
    v[4 * q + 1] = __fmul_rn(XVec<TX>::get(u, 4 * q + 1), f.y);
    v[4 * q + 2] = __fmul_rn(XVec<TX>::get(u, 4 * q + 2), f.z);
    v[4 * q + 3] = __fmul_rn(XVec<TX>::get(u, 4 * q + 3), f.w);
  }
}

template <int N>
__device__ __forceinline__ float vals_amax(const float (&v)[N], float amax) {
#pragma unroll
  for (int e = 0; e < N; ++e) amax = fmaxf(amax, fabsf(v[e]));
  return amax;
}

// N = 8 or 4 values quantized as quant_vec quantizes a vector: a uint2, or
// .x alone.
template <int N>
__device__ __forceinline__ uint2 quant_vals(const float (&v)[N], float inv) {
  uint2 q;
  q.x = quant4(v[0], v[1], v[2], v[3], inv);
  if constexpr (N == 8) {
    q.y = quant4(v[4], v[5], v[6], v[7], inv);
  } else {
    q.y = 0u;
  }
  return q;
}

// The nibbles of a word of four packed int4 bytes (ops/quant.py:pack_int4),
// each sign-extended to a byte: `lo` the low nibbles, `hi` the high ones,
// in the bytes they came from. Bytewise (n ^ 8) - 8, written as
// ((n ^ 8) + 0x78) ^ 0x80 so that no byte carries into the next:
// n ^ 8 <= 15.
__device__ __forceinline__ void unpack_nibbles(uint32_t p, uint32_t& lo,
                                               uint32_t& hi) {
  lo = (((p & 0x0F0F0F0Fu) ^ 0x08080808u) + 0x78787878u) ^ 0x80808080u;
  hi = ((((p >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u) + 0x78787878u) ^ 0x80808080u;
}

// The activation of an f32 epilogue value: exact (erf) GELU or tanh GELU.
__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == kGelu) {
    v = 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
  } else if (act == kGeluTanh) {
    const float inner = 0.79788456080286536f * (v + 0.044715f * v * v * v);
    v = 0.5f * v * (1.0f + tanhf(inner));
  }
  return v;
}

// The int8 epilogue of one accumulator in the TPU kernel's order:
// (acc * x_scale) * w_scale, + bias, then the activation, each step rounded
// on its own (no contraction into an fma).
__device__ __forceinline__ float rescale(int acc, float xs, float ws, float b,
                                         bool has_bias, int act) {
  float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
  if (has_bias) v = __fadd_rn(v, b);
  return apply_act(v, act);
}

}  // namespace ivlm

#ifndef IVLM_EXPORT_ERROR_STRING
// Each library exports this next to its launcher so the Python wrapper can
// turn a non-zero launch status into a readable error.
#define IVLM_EXPORT_ERROR_STRING(prefix)                        \
  extern "C" const char* prefix##_error_string(int code) {      \
    return cudaGetErrorString(static_cast<cudaError_t>(code));  \
  }
#endif
