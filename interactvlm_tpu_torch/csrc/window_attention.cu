// SAM window attention with the decomposed relative-position bias, for
// Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas TPU kernel interactvlm_tpu/ops/sam_attention.py
// `_window_kernel` (wrapper `fused_window_attention`). Each (window, head)
// row attends over its L = H*W tokens with
//   bias[q, c] = f[c / W, q] + f[H + c % W, q],
// where f (R, H+W, L) stacks rel_h and rel_w, the two factor einsums that
// stay outside the kernel. The L x L bias is rebuilt from f by index
// arithmetic and never exists in device memory.
//
// Two routes, by shape alone (ops/sam_attention.py:window_route):
// - "sm90", D = 80 (ViT-H's head dim) and windows up to 16 x 16: the
//   wgmma + TMA kernel of window_attention_sm90.cuh, which reads q, k and v
//   as strided views of the qkv linear's output and whose note says what
//   bounds it and how;
// - "mma", D = 16, 32, 64 (the tiny presets, ViT-B/L's head dim), and 80
//   in windows past 16 x 16: this
//   file's kernel on the mma.sync core of attention_core.cuh, one CTA a
//   64-row query tile, contiguous (R, L, D) rows. At ~90 flops a byte the
//   bytes bound it; the core runs the flash kernel's online softmax over
//   64-key tiles, staging K and V by the threads, and each of a row's query
//   tiles reads the row's K and V again.
#include "attention_core.cuh"
#include "window_attention_sm90.cuh"

using namespace ivlm;

namespace {

constexpr int MAXF = 64;  // largest H + W a window may have

struct WindowBias {
  static constexpr bool kActive = true;
  const bf16 (*f)[BQ];
  int H, W, q0;
  __device__ __forceinline__ float operator()(int r, int c) const {
    const int ql = r - q0;
    const int kh = c / W;
    const int kw = c - kh * W;
    return __bfloat162float(f[kh][ql]) + __bfloat162float(f[H + kw][ql]);
  }
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    window_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ factors,
                  bf16* __restrict__ o, int L, int H, int W, float scale) {
  __shared__ __align__(16) bf16 Ks[BK][D + 8];
  __shared__ __align__(16) bf16 Vs[BK][D + 8];
  __shared__ bf16 fs[MAXF][BQ];
  const int r = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int F = H + W;
  const bf16* fr = factors + (size_t)r * F * L;
  for (int i = threadIdx.x; i < F * BQ; i += NTHREADS) {
    const int j = i / BQ, ql = i % BQ, qq = q0 + ql;
    fs[j][ql] = qq < L ? fr[(size_t)j * L + qq] : __float2bfloat16(0.f);
  }
  __syncthreads();
  const size_t off = (size_t)r * L * D;
  attention_rows<D>(q + off, k + off, v + off, o + off, nullptr, L, L, q0, L,
                    scale, false, 0, WindowBias{fs, H, W, q0}, Ks, Vs);
}

}  // namespace

// route 1 ("sm90"): q/k/v (bw, nh, L, 80) bf16 views with element strides
// sq, sk, sv = (window, head, token), unit stride on the head dim; o
// (bw, L, nh, 80) contiguous. route 0 ("mma"): q/k/v/o (bw * nh, L, D)
// contiguous, D = 16, 32, 64 or 80; the strides are not read. Both: L = H*W,
// factors (bw * nh, H+W, L) bf16 contiguous. Returns the launch status
// (0 = launched).
extern "C" int ivlm_window_attn(const void* q, const void* k, const void* v,
                                const void* factors, void* o, int bw, int nh,
                                int L, int H, int W, int d, int route,
                                long long sq0, long long sq1, long long sq2,
                                long long sk0, long long sk1, long long sk2,
                                long long sv0, long long sv1, long long sv2,
                                float scale, void* stream) {
  const long long rows = (long long)bw * nh;
  if (bw <= 0 || nh <= 0 || L != H * W || H + W > MAXF || L <= 0 ||
      rows > (1ll << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* fp = static_cast<const bf16*>(factors);
  bf16* op = static_cast<bf16*>(o);
  if (route == 1) {
    if (d != win_sm90::kD) return static_cast<int>(cudaErrorInvalidValue);
    const long long sq[3] = {sq0, sq1, sq2}, sk[3] = {sk0, sk1, sk2},
                    sv[3] = {sv0, sv1, sv2};
    return static_cast<int>(win_sm90::launch(qp, kp, vp, sq, sk, sv, fp, op,
                                             bw, nh, L, H, W, scale, st));
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)rows, (L + BQ - 1) / BQ);
#define IVLM_LAUNCH(DIM)                                                     \
  case DIM:                                                                  \
    window_kernel<DIM><<<grid, NTHREADS, 0, st>>>(qp, kp, vp, fp, op, L, H,  \
                                                  W, scale);                 \
    break;
  switch (d) {
    IVLM_LAUNCH(16)
    IVLM_LAUNCH(32)
    IVLM_LAUNCH(64)
    IVLM_LAUNCH(80)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef IVLM_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

IVLM_EXPORT_ERROR_STRING(ivlm_window_attention)
