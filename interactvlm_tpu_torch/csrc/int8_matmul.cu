// Fused int8 quantize + matmul for Hopper (sm_90a) at up to 32 rows (LLaMA
// decode and the lm_head): x (M, K) bf16 or f32, quantized per row inside
// the kernel, times int8 W (N, K) with per-column f32 scales, int32 sums on
// the int8 tensor cores, then the rescale, an optional f32 bias and an
// optional GELU, written as bf16 or f32. One launch, no workspace.
//
// Replaces the Pallas TPU kernel interactvlm_tpu/ops/int8_matmul.py `_kernel`
// / `_kernel_nobias` (wrapper `int8_matmul_fused`) at M <= 32 rows and K <=
// 31744; other calls take the two-pass route (csrc/int8_prequant.cu's row
// quantize, then csrc/int8_gemm_sm90.cu), which gives the same bits. Per
// row: amax = max|x| over K, x_scale = max(amax, 1e-8) / 127, inv = 127 /
// max(amax, 1e-8), xq = clip(rint(x * inv), -127, 127) (round half to even,
// as jnp.round); out = act(f32(acc) * x_scale * w_scale + bias).
//
// What bounds it on the H100: the int8 weight bytes, N K, read once; x and
// the output are a few hundred KB. At 4096 x 4096 that is 5 us, so the
// kernel must keep the card's memory busy from its first microsecond to its
// last: many weight bytes in flight on every SM, and nothing on the path of
// the products that waits for memory. The TPU kernel kept the whole weight
// in VMEM and swept row blocks in order; here:
// - K is split over a thread-block cluster of up to 8 CTAs, the portable
//   size. The wrapper picks it, min(8, K / 128 chunks) (ops/int8_matmul.py
//   one_launch_plan), and CTA r takes chunks [r n / c, (r + 1) n / c) of the
//   n: whole 128-byte chunks, all of K once.
// - The clusters are persistent: as many as fit at once (15 of 8 CTAs on
//   an H100 80GB HBM3, one CTA an SM), each walking blocks of 128 output
//   columns, every CTA streaming its K slice of each block's weight rows.
//   A loader warp keeps a ring of up to 8 stages of 16 KB (128 KB an SM at
//   the decode shapes) full by TMA, across the column blocks.
// - Once a CTA, first: its slice's partial row absmax from global memory,
//   24 loads in flight a lane, before the loader starts (behind the weight
//   stream those loads took microseconds); the cluster swaps the partials
//   through distributed shared memory across a cluster barrier (max is
//   exact in any order, so inv and x_scale are the single-CTA values bit
//   for bit); then the slice, still in registers, quantized into shared
//   memory, where it stays, laid out 128-byte swizzled as TMA lays out W
//   (up to 32 rows x 128 bytes a chunk: 44 KB at K = 11008).
// - Warps 0-3 run wgmma m64nNk32 s8 on each chunk as it lands, the operands
//   swapped: W's 128 rows as two 64-row A tiles, the x rows as the B tile,
//   N = M rounded up to 8, 16 or 32 (the products' time grows with N), both
//   K-major; even and odd chunks into two sets of accumulators, so a chunk
//   need not wait for the last one's products.
// - After each column block warps 0-3 send each int32 partial sum by
//   st.async into the shared memory of the CTA that owns its column (1/c of
//   a block each), where its bytes complete that CTA's barrier; warps 4-7
//   there sum the cluster's partials (int32 addition is exact in any order)
//   and run the epilogue while warps 0-3 go on with the next block: the
//   rescale, bias and activation in the TPU kernel's order, the same f32
//   operations as the two-pass route, so the output equals the two-pass
//   kernels' bit for bit. Buffers are double: a CTA sends into one again
//   after every owner has signalled, by a remote arrive, that it read it.
//   (A release fence or cluster barrier at that point waits for the SM's
//   weight loads in flight, microseconds a block.)
// Rows past M and K past its end are zero in the quantized slice, columns
// past N zero-filled by TMA and masked on store. No host padding.
#include "matmul_core.cuh"
#include "sm90_core.cuh"

#include <mutex>

namespace {

using namespace ivlm;
using namespace ivlm::sm90;

constexpr int kBN = 128;         // output columns (W rows) a block
constexpr int kMP = 32;          // rows of x at most
constexpr int kChunk = 128;      // K values (W bytes) a stage
constexpr int kThreads = 288;    // warps 0-3 products, 4-7 sums, 8 loads
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kMinStages = 4, kMaxStages = 8;
constexpr int kWBytes = kBN * kChunk;  // a stage: 16 KB of W
constexpr int kLoads = 24;             // x loads in flight a lane
// named barriers: the loader's start, the sum warps, warps 0-7
constexpr int kBarStart = 1, kBarSum = 2, kBarWork = 3;

// Shared memory from a 1024-byte boundary: the W ring (`stages` x 16 KB),
// the quantized x slice (`chunks` tiles of `np` rows x 128 bytes), two
// buffers that receive the cluster's partial sums of this CTA's columns
// (up to np x 136 ints), the barriers (full and empty a stage, ready and
// freed a buffer), and the rows' absmax, inv and x_scale.
struct Smem {
  int stages, chunks, np;
  __host__ __device__ int xq() const { return stages * kWBytes; }
  __host__ __device__ int part() const { return xq() + chunks * np * kChunk; }
  __host__ __device__ int part_bytes() const { return np * (kBN + 8) * 4; }
  __host__ __device__ int bar() const { return part() + 2 * part_bytes(); }
  __host__ __device__ int rows() const { return bar() + (2 * kMaxStages + 4) * 8; }
  __host__ __device__ int bytes() const { return 1024 + rows() + 3 * kMP * 4; }
};

struct Args {
  const float* w_scale;  // (N,)
  const float* bias;     // (N,) or null
  void* out;             // (M, N) bf16 or f32
  int out_f32, act, M, N, K;
};

// NP: the rows of x padded to the product's width (8, 16 or 32).
template <typename TX, int NP>
__global__ void __launch_bounds__(kThreads, 1)
    int8_splitk_kernel(const __grid_constant__ CUtensorMap tw,
                       const TX* __restrict__ x, Args a, Smem L) {
  constexpr int VEC = XVec<TX>::kN;  // x values a 16-byte vector
  constexpr int kQ = NP * kChunk;    // a quantized x chunk
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* w_ring = smem;
  unsigned char* xq = smem + L.xq();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar());
  uint64_t* empty = full + kMaxStages;
  uint64_t* ready = empty + kMaxStages;  // a block's partial sums received
  uint64_t* freed = ready + 2;           // ... and read by their owners
  float* amax_s = reinterpret_cast<float*>(smem + L.rows());
  float* inv_s = amax_s + kMP;
  float* xs_s = inv_s + kMP;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cs = gridDim.x;  // the cluster spans the grid's x
  const int S = L.stages;
  const uint32_t rank = cluster_rank();
  const int nch = (a.K + kChunk - 1) / kChunk;
  const int c_lo = rank * nch / cs, nloc = (rank + 1) * nch / cs - c_lo;
  // this cluster's column blocks: blockIdx.y, + gridDim.y, ...
  const int nblocks = ((a.N + kBN - 1) / kBN - blockIdx.y + gridDim.y - 1) /
                      gridDim.y;
  const int steps = nblocks * nloc;  // the ring's stream of (block, chunk)

  auto issue = [&](int g) {  // stream step g into slot g % S
    const int s = g % S;
    const int n0 = (blockIdx.y + (g / nloc) * gridDim.y) * kBN;
    mbar_arrive_expect_tx(&full[s], kWBytes);
    tma_load_2d(w_ring + s * kWBytes, &tw, &full[s],
                (c_lo + g % nloc) * kChunk, n0);
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);   // the loader's arrival with its bytes
      mbar_init(&empty[s], 1);  // the product warps' release
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&ready[b], 1);   // the owner's own arrival, with the bytes
      mbar_init(&freed[b], cs);  // one arrival an owner of the cluster
    }
    fence_barrier_init();
  }
  if (tid < kMP) amax_s[tid] = 0.f;
  for (int i = tid; i < L.chunks * kQ / 16; i += kThreads)  // zeros past M
    reinterpret_cast<uint4*>(xq)[i] = make_uint4(0u, 0u, 0u, 0u);  // and K
  __syncthreads();

  if (warp == 8) {
    // ---- the loader: the weight stream, once warps 0-7 have read x for
    // the absmax (which would otherwise queue behind it)
    bar_sync(kBarStart, kThreads);
    cluster_arrive();  // the absmax exchange below need not wait for this
    if (lane == 0)
      for (int g = 0; g < min(S, steps); ++g) issue(g);
    __syncwarp();
    cluster_wait();
    if (lane == 0)
      for (int g = S; g < steps; ++g) {
        mbar_wait(&empty[g % S], ((g / S) & 1) ^ 1);
        issue(g);
      }
    return;
  }

  // ---- the slice's partial row absmax. Warp w takes rows w, w + 8, ...,
  // its lanes 32 vectors of a row at a time: item f is row w + 8 (f / G),
  // vectors (f % G) 32 + lane, of the G a row. A batch of kLoads items is in
  // flight at once; where one batch holds all (K <= 11264 at 32 rows), its
  // registers are quantized after the exchange without reading x again.
  const int k_lo = c_lo * kChunk, k_hi = min((c_lo + nloc) * kChunk, a.K);
  const int nv = (k_hi - k_lo) / VEC, groups = (nv + 31) / 32;
  const int items = (warp < a.M ? (a.M - warp + 7) / 8 : 0) * groups;
  uint4 v[kLoads];
  // item f0's row and vector group; step() moves to the next item
  int r0 = 0, g0 = 0;
  auto first = [&](int f0) {
    r0 = warp + 8 * (f0 / groups);
    g0 = f0 % groups;
  };
  auto step = [&](int& r, int& g) {
    if (++g == groups) {
      g = 0;
      r += 8;
    }
  };
  auto load = [&](int f0) {
    int r = r0, g = g0;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int col = g * 32 + lane;
      v[u] = (f0 + u < items && col < nv)
                 ? *reinterpret_cast<const uint4*>(
                       x + (size_t)r * a.K + k_lo + col * VEC)
                 : make_uint4(0u, 0u, 0u, 0u);
      step(r, g);
    }
  };
  for (int f0 = 0; f0 < items; f0 += kLoads) {
    first(f0);
    load(f0);
    int r = r0, g = g0;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (f0 + u < items) {  // warp-uniform
        const float m = warp_max(vec_amax<TX>(v[u], 0.f));
        if (lane == 0) amax_s[r] = fmaxf(amax_s[r], m);
      }
      step(r, g);
    }
  }
  bar_arrive(kBarStart, kThreads);  // the weight stream may start
  cluster_sync();  // every CTA's partial absmax is written
  if (tid < kMP) {
    float amax = 0.f;
    for (int q = 0; q < cs; ++q)
      amax = fmaxf(amax, ld_cluster_f32(cluster_addr(&amax_s[tid], q)));
    row_scales(amax, inv_s[tid], xs_s[tid]);
  }
  bar_sync(kBarWork, 256);

  // ---- the slice quantized into shared memory, 128-byte swizzled
  for (int f0 = 0; f0 < items; f0 += kLoads) {
    if (items > kLoads) {  // else v holds the one batch
      first(f0);
      load(f0);
    }
    int r = r0, g = g0;
#pragma unroll
    for (int u = 0; u < kLoads; ++u, step(r, g)) {
      const int k = (g * 32 + lane) * VEC;
      if (f0 + u < items && k < k_hi - k_lo) {
        const uint2 q = quant_vec<TX>(v[u], inv_s[r]);
        unsigned char* p = xq + (k / kChunk) * kQ + sw128_offset(r, k % kChunk);
        if constexpr (VEC == 8) {
          *reinterpret_cast<uint2*>(p) = q;
        } else {
          *reinterpret_cast<uint32_t*>(p) = q.x;
        }
      }
    }
  }
  fence_proxy_async();  // the wgmma reads xq through the async proxy
  bar_sync(kBarWork, 256);

  // ---- the column blocks. Warps 0-3 run block j's products and send each
  // partial sum by st.async into buffer j % 2 of the CTA that owns its
  // column (CTA r owns columns [128 r / c, 128 (r + 1) / c) of a block),
  // where it lands on barrier `ready`; warps 4-7 wait there, sum the
  // cluster's partials of their columns, write the output and arrive at
  // `freed` in every CTA, while warps 0-3 go on with block j + 1. A CTA
  // sends into a buffer again (block j + 2) once `freed` says every owner
  // has read it.
  const int cmax = (kBN + cs - 1) / cs;  // columns a CTA owns at most
  if (warp < 4) {
    // two accumulator sets, even and odd chunks, so that a chunk's products
    // need not wait for the previous chunk's: W rows as A, x rows as B
    int acc[2][2][NP / 2];
    auto chunk = [&](int j, int c, int (&ac)[2][NP / 2]) {
      const int g = j * nloc + c, s = g % S;
      mbar_wait(&full[s], (g / S) & 1);
      const uint32_t w = smem_addr(w_ring + s * kWBytes);
      const uint32_t b = smem_addr(xq + c * kQ);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 32; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wgmma_s8(ac[h], desc_kmajor(w + h * 64 * kChunk + kk * 32),
                   desc_kmajor(b + kk * 32));
      wgmma_commit();
      if (c > 0) {  // the previous chunk's products are done: free it
        wgmma_wait<1>();
        if (tid == 0) mbar_arrive(&empty[(g - 1) % S]);
      }
    };
    const int gr = lane >> 2, t = lane & 3;
    for (int j = 0; j < nblocks; ++j) {
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < NP / 2; ++i) acc[p][h][i] = 0;
      for (int c = 0; c < nloc; c += 2) {
        chunk(j, c, acc[0]);
        if (c + 1 < nloc) chunk(j, c + 1, acc[1]);
      }
      wgmma_wait<0>();
      if (tid == 0) mbar_arrive(&empty[(j * nloc + nloc - 1) % S]);
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h) fence_regs(acc[p][h]);
      if (j >= 2) mbar_wait_cluster(&freed[j & 1], ((j >> 1) - 1) & 1);
      // element 4 i + e of warp w's lane (gr, t) in tile h: W row
      // n = 64 h + 16 w + gr + 8 (e / 2), x row m = 8 i + 2 t + e % 2; it
      // goes to row (rank, m) of its owner q's buffer, at column n - lo(q)
      unsigned char* buf = smem + L.part() + (j & 1) * L.part_bytes();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int n = 64 * h + 16 * warp + gr + 8 * e2;
          const int q = ((n + 1) * cs - 1) / kBN;
          const int nl = n - q * kBN / cs;
          const uint32_t bar = cluster_addr(&ready[j & 1], q);
          const uint32_t row0 = cluster_addr(buf, q) + (rank * NP * cmax + nl) * 4;
#pragma unroll
          for (int i = 0; i < NP / 8; ++i)
#pragma unroll
            for (int e1 = 0; e1 < 2; ++e1) {
              const int m = 8 * i + 2 * t + e1;
              if (m < a.M)
                st_async_s32(row0 + m * cmax * 4,
                             acc[0][h][4 * i + 2 * e2 + e1] +
                                 acc[1][h][4 * i + 2 * e2 + e1],
                             bar);
            }
        }
    }
    // stay until every owner has read this CTA's last two blocks
    for (int j = max(0, nblocks - 2); j < nblocks; ++j)
      mbar_wait_cluster(&freed[j & 1], (j >> 1) & 1);
  } else {
    const bool has_bias = a.bias != nullptr;
    const int lo = rank * kBN / cs, cnt = (rank + 1) * kBN / cs - lo;
    for (int j = 0; j < nblocks; ++j) {
      uint64_t* bar = &ready[j & 1];
      if (tid == 128) mbar_arrive_expect_tx(bar, cs * a.M * cnt * 4);
      mbar_wait(bar, (j >> 1) & 1);
      const int n0 = (blockIdx.y + j * gridDim.y) * kBN + lo;
      const int* buf = reinterpret_cast<const int*>(
          smem + L.part() + (j & 1) * L.part_bytes());
      for (int i = tid - 128; i < cnt * a.M; i += 128) {
        const int m = i / cnt, nl = i % cnt, gn = n0 + nl;
        if (gn >= a.N) continue;
        int sum = 0;
        for (int q = 0; q < cs; ++q) sum += buf[(q * NP + m) * cmax + nl];
        const float v = rescale(sum, xs_s[m], a.w_scale[gn],
                                has_bias ? a.bias[gn] : 0.f, has_bias, a.act);
        const size_t o = (size_t)m * a.N + gn;
        if (a.out_f32)
          static_cast<float*>(a.out)[o] = v;
        else
          static_cast<bf16*>(a.out)[o] = __float2bfloat16_rn(v);
      }
      bar_sync(kBarSum, 128);  // the sums above used every value read
      if (tid == 128)
        for (int q = 0; q < cs; ++q) mbar_arrive_remote(&freed[j & 1], q);
    }
  }
}

// The largest dynamic shared memory a block may take on a device.
inline int max_smem(int dev) {
  static int v[64] = {0};
  if (dev < 0 || dev >= 64) return 0;
  if (v[dev] == 0)
    cudaDeviceGetAttribute(&v[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v[dev];
}

// The clusters of a kernel that fit on the card at once, per device, cluster
// size and shared memory, looked up once.
struct Fit {
  int dev, cluster, bytes, clusters;
  const void* kernel;
};

template <typename TX, int NP>
cudaError_t launch(const void* x, const void* w, const Args& a, int cluster,
                   cudaStream_t st) {
  static std::mutex mu;
  static Fit fits[64];
  static int nfits = 0;
  auto kernel = int8_splitk_kernel<TX, NP>;
  int dev = 0;
  cudaGetDevice(&dev);
  const int nch = (a.K + kChunk - 1) / kChunk;
  Smem L{0, (nch + cluster - 1) / cluster, NP};
  L.stages = min(kMaxStages, (max_smem(dev) - L.bytes()) / kWBytes);
  if (L.stages < kMinStages) return cudaErrorInvalidValue;
  CUtensorMap tw;
  const cuuint64_t dw[2] = {(cuuint64_t)a.K, (cuuint64_t)a.N};
  const cuuint64_t sw[1] = {(cuuint64_t)a.K};
  const cuuint32_t bw[2] = {kChunk, kBN};
  if (!encode_sw128(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, dw, sw, bw))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = L.bytes();
  cfg.stream = st;
  int clusters = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < nfits; ++i)
      if (fits[i].dev == dev && fits[i].cluster == cluster &&
          fits[i].bytes == L.bytes() && fits[i].kernel == (const void*)kernel)
        clusters = fits[i].clusters;
    if (clusters == 0) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem(dev));
      if (e != cudaSuccess) return e;
      cfg.gridDim = dim3(cluster, 1, 1);
      e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (e != cudaSuccess) return e;
      if (clusters <= 0) return cudaErrorInvalidConfiguration;
      if (nfits < 64)
        fits[nfits++] = Fit{dev, cluster, L.bytes(), clusters, (const void*)kernel};
    }
  }
  const int blocks = (a.N + kBN - 1) / kBN;
  cfg.gridDim = dim3(cluster, min(blocks, clusters), 1);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, tw, static_cast<const TX*>(x), a, L);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TX>
cudaError_t launch_rows(const void* x, const void* w, const Args& a,
                        int cluster, cudaStream_t st) {
  if (a.M <= 8) return launch<TX, 8>(x, w, a, cluster, st);
  if (a.M <= 16) return launch<TX, 16>(x, w, a, cluster, st);
  return launch<TX, 32>(x, w, a, cluster, st);
}

}  // namespace

// x: (M, K) bf16 (x_f32 = 0) or f32, contiguous; w: (N, K) int8, contiguous;
// w_scale: (N,) f32; bias: (N,) f32 or null; out: (M, N) bf16 (out_f32 = 0)
// or f32; act: 0 none, 1 exact GELU, 2 tanh GELU. 1 <= M <= 32, K % 32 == 0,
// K <= 31744 (the quantized slice and 4 ring stages fit 227 KB), N % 8 ==
// 0, every pointer 16-byte aligned; `cluster` CTAs split K, 1 to 8 and at
// most K / 128 rounded up (ops/int8_matmul.py:one_launch_plan).
// Returns the launch status (0 = launched).
extern "C" int ivlm_int8_matmul(const void* x, int x_f32, const void* w,
                                const void* w_scale, const void* bias,
                                void* out, int out_f32, int act, int M, int N,
                                int K, int cluster, void* stream) {
  if (M <= 0 || M > kMP || N <= 0 || K <= 0 || K % 32 != 0 || N % 8 != 0 ||
      act < 0 || act > 2 || cluster < 1 || cluster > kMaxCluster ||
      cluster > (K + kChunk - 1) / kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(w_scale),
               static_cast<const float*>(bias), out, out_f32, act, M, N, K};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = x_f32 ? launch_rows<float>(x, w, a, cluster, st)
                                : launch_rows<bf16>(x, w, a, cluster, st);
  return static_cast<int>(err);
}

IVLM_EXPORT_ERROR_STRING(ivlm_int8_matmul)
