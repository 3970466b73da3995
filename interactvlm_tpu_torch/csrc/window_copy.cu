// The window-attention copy probe for Hopper (sm_90a): reads q, k and v
// (R, L, D) bf16 in the window kernel's grid and 64-row tiles and writes
// o = q, bit for bit.
//
// Replaces the Pallas TPU kernel scripts/winattn_probe.py `_copy` (its
// pallas_call at :129), which ran the window kernel's grid and block specs
// over q, k and v padded to (224, 128) with a body that only copies q, to
// time padding, DMA and grid overhead apart from the attention's arithmetic
// (the function it computes: out[:, :, :L, :D] == q). The port's window
// kernel (csrc/window_attention.cu) pads nothing: its grid is (R, ceil(L /
// 64)) blocks of 128 threads over the natural L and D. This kernel runs that
// grid; each block copies its 64 rows of q to o with 16-byte loads and
// stores, and stages the same rows of k and v in shared memory with
// cp.async (which the compiler cannot drop), so every input byte is read
// once and every output byte written once: bytes bound it, 4 R L D 2 of
// them, and its time is the memory floor under the window kernel's.
#include "matmul_core.cuh"

namespace {

using namespace ivlm;

constexpr int BQ = 64, NTHREADS = 128, MAXD = 128;

__global__ void __launch_bounds__(NTHREADS)
    window_copy_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o, int L,
                       int D) {
  __shared__ __align__(16) bf16 k_s[BQ * MAXD];
  __shared__ __align__(16) bf16 v_s[BQ * MAXD];
  const int q0 = blockIdx.y * BQ;
  const int rows = min(BQ, L - q0);
  const int n = rows * D / 8;  // 16-byte pieces in the tile
  const size_t base = ((size_t)blockIdx.x * L + q0) * D;
  const uint4* qs = reinterpret_cast<const uint4*>(q + base);
  uint4* os = reinterpret_cast<uint4*>(o + base);
  for (int i = threadIdx.x; i < n; i += NTHREADS) {
    cp_async16(&k_s[i * 8], k + base + (size_t)i * 8, true);
    cp_async16(&v_s[i * 8], v + base + (size_t)i * 8, true);
    os[i] = qs[i];
  }
  cp_async_commit();
  cp_async_wait<0>();
}

}  // namespace

// q, k, v, o: (R, L, D) bf16, contiguous and 16-byte aligned, D % 8 == 0,
// D <= 128. Returns the launch status (0 = launched).
extern "C" int ivlm_window_copy(const void* q, const void* k, const void* v,
                                void* o, int rows, int L, int D,
                                void* stream) {
  if (rows <= 0 || L <= 0 || D <= 0 || D % 8 != 0 || D > MAXD)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(rows, (L + BQ - 1) / BQ);
  window_copy_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), L, D);
  return static_cast<int>(cudaGetLastError());
}

IVLM_EXPORT_ERROR_STRING(ivlm_window_copy)
