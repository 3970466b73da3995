// SAM global attention with the decomposed relative-position bias, for
// Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas TPU kernel interactvlm_tpu/ops/sam_attention.py
// `_kernel` (wrapper `fused_rel_attention`): flash attention over an H x W
// token grid (64 x 64 = 4096 tokens in ViT-H's global blocks) with
//   bias[q, c] = rel_h[c / W, q] + rel_w[q, c % W],
// rel_h (BH, H, L) and rel_w (BH, L, W) coming from two einsums outside the
// kernel. Each CTA stages the rel_h columns and rel_w rows of its query
// rows in shared memory once and rebuilds every bias tile from them, so the
// (L, L) bias (4 GB in f32 for 512 rows) never exists.
//
// Two routes, by head dim alone (ops/sam_attention.py:rel_route):
// - "sm90", D = 80, the ViT-H head dim: the wgmma + TMA kernel of
//   rel_attention_sm90.cuh, whose note says what bounds it and how;
// - "mma", D = 16, 32, 64 (the tiny presets and card tests): this file's
//   kernel, Q in registers and both products on bf16 mma.sync with f32
//   accumulation, K and V staged by the threads 64 keys at a time.
//   4 L^2 D flops a row against ~2 L D bytes: the tensor-core rate bounds
//   it, which this kernel, with no wgmma or TMA, stays well below.
#include "attention_core.cuh"
#include "rel_attention_sm90.cuh"

using namespace ivlm;

namespace {

constexpr int MAXHW = 64;  // largest grid height or width

struct RelBias {
  static constexpr bool kActive = true;
  const bf16 (*rh)[BQ];
  const bf16 (*rw)[MAXHW + 2];
  int W, q0;
  __device__ __forceinline__ float operator()(int r, int c) const {
    const int ql = r - q0;
    const int kh = c / W;
    const int kw = c - kh * W;
    return __bfloat162float(rh[kh][ql]) + __bfloat162float(rw[ql][kw]);
  }
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    rel_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ rel_h,
               const bf16* __restrict__ rel_w, bf16* __restrict__ o, int L,
               int H, int W, float scale) {
  __shared__ __align__(16) bf16 Ks[BK][D + 8];
  __shared__ __align__(16) bf16 Vs[BK][D + 8];
  __shared__ bf16 rh_s[MAXHW][BQ];
  __shared__ bf16 rw_s[BQ][MAXHW + 2];  // +2: rows land on distinct banks
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const bf16* rh = rel_h + (size_t)bh * H * L;
  const bf16* rw = rel_w + (size_t)bh * L * W;
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < H * BQ; i += NTHREADS) {
    const int kh = i / BQ, ql = i % BQ, qq = q0 + ql;
    rh_s[kh][ql] = qq < L ? rh[(size_t)kh * L + qq] : zero;
  }
  for (int i = threadIdx.x; i < BQ * W; i += NTHREADS) {
    const int ql = i / W, kw = i % W, qq = q0 + ql;
    rw_s[ql][kw] = qq < L ? rw[(size_t)qq * W + kw] : zero;
  }
  __syncthreads();
  const size_t off = (size_t)bh * L * D;
  attention_rows<D>(q + off, k + off, v + off, o + off, nullptr, L, L, q0, L,
                    scale, false, 0, RelBias{rh_s, rw_s, W, q0}, Ks, Vs);
}

}  // namespace

// q/k/v/o: (BH, L, D) bf16 contiguous, L = H*W; rel_h: (BH, H, L) bf16;
// rel_w: (BH, L, W) bf16. route 1 ("sm90") takes D = 80, route 0 ("mma")
// D = 16, 32 or 64. Returns the launch status (0 = launched).
extern "C" int ivlm_rel_attn(const void* q, const void* k, const void* v,
                             const void* rel_h, const void* rel_w, void* o,
                             int bh, int L, int H, int W, int d, int route,
                             float scale, void* stream) {
  if (bh <= 0 || L != H * W || H > MAXHW || W > MAXHW || L <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* hp = static_cast<const bf16*>(rel_h);
  const bf16* wp = static_cast<const bf16*>(rel_w);
  bf16* op = static_cast<bf16*>(o);
  if (route == 1) {
    if (d != rel_sm90::kD) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        rel_sm90::launch(qp, kp, vp, hp, wp, op, bh, L, H, W, scale, st));
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(bh, (L + BQ - 1) / BQ);
#define IVLM_LAUNCH(DIM)                                                     \
  case DIM:                                                                  \
    rel_kernel<DIM><<<grid, NTHREADS, 0, st>>>(qp, kp, vp, hp, wp, op, L, H, \
                                               W, scale);                    \
    break;
  switch (d) {
    IVLM_LAUNCH(16)
    IVLM_LAUNCH(32)
    IVLM_LAUNCH(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef IVLM_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

IVLM_EXPORT_ERROR_STRING(ivlm_rel_attention)
