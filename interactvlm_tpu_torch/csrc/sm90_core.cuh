// Shared device and host code of the hand-written kernels that run on
// Hopper's own machinery (sm_90a): the TMA tensor-map encode (host), the
// mbarrier ring primitives, TMA tile loads, the wgmma shared-memory matrix
// descriptors for 128-byte-swizzled tiles, the wgmma fence / commit / wait
// wrappers and products, setmaxnreg, named barriers, and the thread-block
// cluster's pieces (the cluster barrier, distributed shared memory reads,
// remote barrier arrivals and st.async stores). Used by the GEMM skeleton
// (gemm_sm90.cuh: the int8 GEMM and the bf16 serving matmul), the one-launch
// int8 matmul (int8_matmul.cu), the D = 128 flash forward
// (flash_fwd_sm90.cuh), the D = 80 global rel-pos attention
// (rel_attention_sm90.cuh), the D = 80 window attention
// (window_attention_sm90.cuh) and the tensor-core rate loop (mxu_probe.cu).
//
// The tensor map is encoded on the host at every launch from the tensors'
// pointers (a few microseconds). cuTensorMapEncodeTiled is a driver-API
// function; the libraries link only the runtime, so the function is reached
// through cudaGetDriverEntryPoint*, and <cuda.h> is included for its types
// alone.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ivlm {
namespace sm90 {

// ------------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor of `rank` dimensions (dims innermost first, the innermost of
// unit stride, strides in bytes of dimensions 1..rank-1, any order) cut
// into boxes of `box` elements, the innermost box row as wide as the
// swizzle span (128 or 32 bytes), swizzled so in shared memory. Reads
// outside the tensor fill zeros. Returns false if the driver refuses.
inline bool encode_swizzled(CUtensorMap* map, CUtensorMapDataType type,
                            int rank, const void* base,
                            const cuuint64_t* dims, const cuuint64_t* strides,
                            const cuuint32_t* box, CUtensorMapSwizzle sw) {
  const EncodeTiled fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// encode_swizzled with rows of exactly 128 bytes, 128-byte swizzled.
inline bool encode_sw128(CUtensorMap* map, CUtensorMapDataType type,
                         int rank, const void* base, const cuuint64_t* dims,
                         const cuuint64_t* strides, const cuuint32_t* box) {
  return encode_swizzled(map, type, rank, base, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

// The card's SM count, read once per device.
inline int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (128-byte-swizzled tiles must
// start on one).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// one arrival that also expects `bytes` of TMA transfers on this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed (a
// barrier starts in phase 0; waiting on parity 1 first returns at once).
// A wait that never ends is a fault (a lost arrival or transfer): after
// 2^26 polls, seconds on the card, it traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// TMA: one box of the tensor map at the given coordinates (innermost first)
// into shared memory; completion is reported to `bar` as transferred bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// A bulk copy (no tensor map) of `bytes` (a multiple of 16) from device
// memory at src into shared memory at dst, both 16-byte aligned;
// completion is reported to `bar` as transferred bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Named barrier `id` (1-15) over `count` threads (a multiple of 32): sync
// waits for all of them, arrive only counts this warp in.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (a wgmma operand written by threads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The byte offset of element (row, k) of a tile of rows of 128 bytes,
// 128-byte swizzled as TMA writes it: the 16-byte piece k / 16 of a row
// moves to piece (k / 16) xor (row % 8). Threads that write a wgmma operand
// themselves place it here.
__device__ __forceinline__ uint32_t sw128_offset(uint32_t row, uint32_t k) {
  return row * 128u + ((((k >> 4) ^ row) & 7u) << 4) + (k & 15u);
}

// ---- thread-block clusters

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster barrier: every thread of every CTA of the cluster arrives,
// then waits until all have (shared memory written before an arrival is
// visible to the cluster's reads after the wait). A thread may work between
// its arrival and its wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The address in CTA `rank`'s shared memory of what sits at p in ours.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr)
               : "memory");
  return v;
}

// One arrival on the barrier at `bar` in CTA `rank`'s shared memory, with
// no memory ordering: the arriving thread's earlier reads have returned
// their values where those were used before it.
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar,
                                                   uint32_t rank) {
  asm volatile("mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [%0];\n"
               ::"r"(cluster_addr(bar, rank))
               : "memory");
}

// As mbar_wait, acquiring at cluster scope what the arrivals released.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// An asynchronous store of v into another CTA's shared memory (`addr` from
// cluster_addr) that reports its 4 bytes to that CTA's barrier at `bar`
// (also from cluster_addr): the data is visible to whoever waits there
// once the phase completes, with no fence on either side.
__device__ __forceinline__ void st_async_s32(uint32_t addr, int v,
                                             uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(v), "r"(bar)
      : "memory");
}

// The wgmma matrix descriptor of a 128-byte-swizzled tile in shared memory
// at byte address `addr` (tiles start on 1024-byte boundaries; an address
// inside a swizzle row selects a K offset): bits 0-13 address / 16, 16-29
// the leading byte offset / 16, 32-45 the stride byte offset / 16, 62-63
// the layout (1: 128-byte swizzle). K-major: rows of 128 bytes along K,
// groups of 8 rows `sbo` = 1024 bytes apart, `lbo` unused. MN-major: rows
// of 128 bytes along M or N, one row a K index; `lbo` is the distance
// between 128-byte panels along M or N, `sbo` between groups of 8 K rows.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}

// The same for a 32-byte-swizzled tile (layout 3; tiles start on 256-byte
// boundaries): K-major, rows of 32 bytes (one k16 step of bf16), groups of
// 8 rows `sbo` = 256 bytes apart; MN-major, rows of 32 bytes along M or N
// (16 bf16), one row a K index, `sbo` = 256 between groups of 8 K rows,
// `lbo` between 32-byte panels along M or N.
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) | (3ull << 62);
}

// 2^x on the special-function unit; results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A wgmma descriptor `bytes` further on in shared memory: the low word
// holds the address / 16, and no step inside a tile carries out of it.
__device__ __forceinline__ uint64_t desc_at(uint64_t d, uint32_t bytes) {
  return (d & 0xFFFFFFFF00000000ull) |
         static_cast<uint32_t>(static_cast<uint32_t>(d) + (bytes >> 4));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed wgmma groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across a wait: the asynchronous product writes them behind its back.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Registers a thread of this warpgroup may hold from here on (a multiple of
// 8 in [24, 256]): the producer gives some up, the consumers take them.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

#define IVLM_ACC8_S32(d, i)                                                 \
  "+r"(d[i + 0]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),           \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define IVLM_ACC8_F32(d, i)                                                 \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define IVLM_OUT8_F32(d, i)                                                 \
  "=f"(d[i + 0]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]),           \
      "=f"(d[i + 4]), "=f"(d[i + 5]), "=f"(d[i + 6]), "=f"(d[i + 7])

// The wgmma products: each thread of the warpgroup holds N / 2 accumulators
// of the 64 x N tile; element 4 j + e of warp w's lane (g = lane / 4,
// t = lane % 4) sits at row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2.

// d (+)= a b, m64n256k32, s8 x s8 -> s32, both operands from shared memory
// (K-major); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : IVLM_ACC8_S32(d, 0),
        IVLM_ACC8_S32(d, 8),
        IVLM_ACC8_S32(d, 16),
        IVLM_ACC8_S32(d, 24),
        IVLM_ACC8_S32(d, 32),
        IVLM_ACC8_S32(d, 40),
        IVLM_ACC8_S32(d, 48),
        IVLM_ACC8_S32(d, 56),
        IVLM_ACC8_S32(d, 64),
        IVLM_ACC8_S32(d, 72),
        IVLM_ACC8_S32(d, 80),
        IVLM_ACC8_S32(d, 88),
        IVLM_ACC8_S32(d, 96),
        IVLM_ACC8_S32(d, 104),
        IVLM_ACC8_S32(d, 112),
        IVLM_ACC8_S32(d, 120)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= a b, m64n128k32, s8 x s8 -> s32, both operands from shared memory
// (K-major); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p;\n}\n"
      : IVLM_ACC8_S32(d, 0),
        IVLM_ACC8_S32(d, 8),
        IVLM_ACC8_S32(d, 16),
        IVLM_ACC8_S32(d, 24),
        IVLM_ACC8_S32(d, 32),
        IVLM_ACC8_S32(d, 40),
        IVLM_ACC8_S32(d, 48),
        IVLM_ACC8_S32(d, 56)
      : "l"(a), "l"(b), "r"(scale_d));
}


// d += a b, m64nNk32 for N = 8, 16, 32, s8 x s8 -> s32, both operands from
// shared memory (K-major).
__device__ __forceinline__ void wgmma_s8(int (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
      : IVLM_ACC8_S32(d, 0)
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      : IVLM_ACC8_S32(d, 0),
        IVLM_ACC8_S32(d, 8)
      : "l"(a), "l"(b), "r"(1));
}

// d (+)= a b, m64n256k16, bf16 x bf16 -> f32, both operands from shared
// memory, both K-major; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_bf16_ss_n256(float (&d)[128], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : IVLM_ACC8_F32(d, 0),
        IVLM_ACC8_F32(d, 8),
        IVLM_ACC8_F32(d, 16),
        IVLM_ACC8_F32(d, 24),
        IVLM_ACC8_F32(d, 32),
        IVLM_ACC8_F32(d, 40),
        IVLM_ACC8_F32(d, 48),
        IVLM_ACC8_F32(d, 56),
        IVLM_ACC8_F32(d, 64),
        IVLM_ACC8_F32(d, 72),
        IVLM_ACC8_F32(d, 80),
        IVLM_ACC8_F32(d, 88),
        IVLM_ACC8_F32(d, 96),
        IVLM_ACC8_F32(d, 104),
        IVLM_ACC8_F32(d, 112),
        IVLM_ACC8_F32(d, 120)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= a b, m64n64k16, bf16 x bf16 -> f32, both operands from shared
// memory, both K-major; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_bf16_ss_n64(float (&d)[32], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : IVLM_ACC8_F32(d, 0),
        IVLM_ACC8_F32(d, 8),
        IVLM_ACC8_F32(d, 16),
        IVLM_ACC8_F32(d, 24)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d = a b, m64n64k16: the first step of a product, which reads nothing
// of d.
__device__ __forceinline__ void wgmma_bf16_ss_n64_set(float (&d)[32], uint64_t a,
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : IVLM_OUT8_F32(d, 0),
        IVLM_OUT8_F32(d, 8),
        IVLM_OUT8_F32(d, 16),
        IVLM_OUT8_F32(d, 24)
      : "l"(a), "l"(b), "r"(0));
}

// d (+)= a b, m64n128k16, bf16 x bf16 -> f32: a from registers (the
// mma.m16n8k16 A fragment of each warp's 16 rows), b from shared memory,
// MN-major (transposed); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_bf16_rs_n128_tb(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : IVLM_ACC8_F32(d, 0),
        IVLM_ACC8_F32(d, 8),
        IVLM_ACC8_F32(d, 16),
        IVLM_ACC8_F32(d, 24),
        IVLM_ACC8_F32(d, 32),
        IVLM_ACC8_F32(d, 40),
        IVLM_ACC8_F32(d, 48),
        IVLM_ACC8_F32(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

// d (+)= a b, m64n80k16, bf16 x bf16 -> f32: a from registers as for
// wgmma_bf16_rs_n128_tb, b from shared memory, MN-major (transposed);
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_bf16_rs_n80_tb(float (&d)[40],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : IVLM_ACC8_F32(d, 0),
        IVLM_ACC8_F32(d, 8),
        IVLM_ACC8_F32(d, 16),
        IVLM_ACC8_F32(d, 24),
        IVLM_ACC8_F32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

// d = a b, m64n224k16 and m64n256k16, bf16 x bf16 -> f32, both operands
// from shared memory, K-major: the first step of a product, which reads
// nothing of d.

__device__ __forceinline__ void wgmma_bf16_ss_n224_set(float (&d)[112], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111"
      "}, "
      "%112, %113, p, 1, 1, 0, 0;\n}\n"
      : IVLM_OUT8_F32(d, 0),
        IVLM_OUT8_F32(d, 8),
        IVLM_OUT8_F32(d, 16),
        IVLM_OUT8_F32(d, 24),
        IVLM_OUT8_F32(d, 32),
        IVLM_OUT8_F32(d, 40),
        IVLM_OUT8_F32(d, 48),
        IVLM_OUT8_F32(d, 56),
        IVLM_OUT8_F32(d, 64),
        IVLM_OUT8_F32(d, 72),
        IVLM_OUT8_F32(d, 80),
        IVLM_OUT8_F32(d, 88),
        IVLM_OUT8_F32(d, 96),
        IVLM_OUT8_F32(d, 104)
      : "l"(a), "l"(b), "r"(0));
}

__device__ __forceinline__ void wgmma_bf16_ss_n256_set(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : IVLM_OUT8_F32(d, 0),
        IVLM_OUT8_F32(d, 8),
        IVLM_OUT8_F32(d, 16),
        IVLM_OUT8_F32(d, 24),
        IVLM_OUT8_F32(d, 32),
        IVLM_OUT8_F32(d, 40),
        IVLM_OUT8_F32(d, 48),
        IVLM_OUT8_F32(d, 56),
        IVLM_OUT8_F32(d, 64),
        IVLM_OUT8_F32(d, 72),
        IVLM_OUT8_F32(d, 80),
        IVLM_OUT8_F32(d, 88),
        IVLM_OUT8_F32(d, 96),
        IVLM_OUT8_F32(d, 104),
        IVLM_OUT8_F32(d, 112),
        IVLM_OUT8_F32(d, 120)
      : "l"(a), "l"(b), "r"(0));
}

// d (+)= a b, m64n224k16, as wgmma_bf16_ss_n256; scale_d = 0 overwrites d.

__device__ __forceinline__ void wgmma_bf16_ss_n224(float (&d)[112], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111"
      "}, "
      "%112, %113, p, 1, 1, 0, 0;\n}\n"
      : IVLM_ACC8_F32(d, 0),
        IVLM_ACC8_F32(d, 8),
        IVLM_ACC8_F32(d, 16),
        IVLM_ACC8_F32(d, 24),
        IVLM_ACC8_F32(d, 32),
        IVLM_ACC8_F32(d, 40),
        IVLM_ACC8_F32(d, 48),
        IVLM_ACC8_F32(d, 56),
        IVLM_ACC8_F32(d, 64),
        IVLM_ACC8_F32(d, 72),
        IVLM_ACC8_F32(d, 80),
        IVLM_ACC8_F32(d, 88),
        IVLM_ACC8_F32(d, 96),
        IVLM_ACC8_F32(d, 104)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= a b, m64n64k16 and m64n16k16, bf16 x bf16 -> f32: a from
// registers as for wgmma_bf16_rs_n128_tb, b from shared memory, MN-major
// (transposed); scale_d = 0 overwrites d.

__device__ __forceinline__ void wgmma_bf16_rs_n64_tb(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : IVLM_ACC8_F32(d, 0),
        IVLM_ACC8_F32(d, 8),
        IVLM_ACC8_F32(d, 16),
        IVLM_ACC8_F32(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_rs_n16_tb(float (&d)[8],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : IVLM_ACC8_F32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

#undef IVLM_ACC8_S32
#undef IVLM_ACC8_F32
#undef IVLM_OUT8_F32

}  // namespace sm90
}  // namespace ivlm
