// Fused int4-weight matmul for Hopper (sm_90a) at up to 32 rows (LLaMA
// decode and the lm_head): x (M, K) bf16 or f32 times the row factor rf
// (K,), quantized per row inside the kernel, times a packed int4 weight
// (N, K/2) with per-column f32 scales, int32 sums on the int8 tensor cores,
// then out = (f32(acc) * x_scale) * w_scale written as bf16 or f32. One
// launch, no workspace. Byte j of a weight row holds column j in its low
// nibble and column j + K/2 in its high one (ops/quant.py:pack_int4), so
// acc = sum_{j < K/2} xq[j] lo[j] + xq[K/2 + j] hi[j], for the int8
// quantization of the f32 products x * rf: amax = max|x rf| over the row,
// inv = 127 / max(amax, 1e-8), x_scale = max(amax, 1e-8) / 127, xq =
// clip(rint(x rf inv), -127, 127) half to even. The sum is exact and the
// epilogue is kernel 6's, so the output equals the unpack-then-kernel-6
// route on f32 x * rf bit for bit (ops/int4_matmul.py).
//
// It replaces no Pallas kernel: the JAX package leaves the int4 product to
// XLA's fusion of the unpack into its two half-K dots
// (interactvlm_tpu/ops/quant.py:int4_matmul). It is the decode route of
// ops/int4_matmul.py:int4_matmul_fused (M <= 32); above, kernel 7 with the
// row factor then csrc/int4_gemm_sm90.cu.
//
// What bounds it on the H100: the packed weight bytes, N K / 2, read once
// (8 MB at 4096 x 4096, 3.3 GB for a LLaMA-7B decode step, ~1 ms at 3.35
// TB/s); x and the output are a few hundred KB. So the weight stream must
// start with the kernel and nothing may wait on it:
// - K is split over a thread-block cluster of `cluster` CTAs and the
//   clusters walk blocks of 128 output columns, both picked per shape in
//   Python (ops/int4_matmul.py:decode_plan, with the clusters the card
//   holds at once, ivlm_int4_matmul_clusters) so that the CTAs fill the SMs
//   in one wave with about equal shares of the packed chunks (128 bytes a
//   weight row, 256 K values). CTA r takes chunks [r n / c, (r + 1) n / c)
//   of the n: its slice of x is two pieces, columns [256 c0, 256 c1) / 2
//   and K/2 plus those.
// - A loader warp issues the first ring stages by TMA as soon as the
//   barriers exist, before anything reads x, and keeps the ring full
//   across the column blocks (the int8 kernel's order, the stream held
//   until the x reads are done, was nowhere faster at LLaMA-7B's decode
//   shapes; PERF.md).
// - Meanwhile warps 0-7 read the slice of x and rf, a batch of loads in
//   flight a lane, form x * rf in f32 registers and take the slice's
//   partial row absmax (a lane's max over its vectors, then one warp max a
//   row); each CTA sends its partials by st.async into every CTA of the
//   cluster, where the bytes complete a barrier (a cluster barrier's
//   release would wait for the SM's TMA loads in flight: the one cluster
//   barrier, which orders the barriers' init before any remote signal,
//   arrives relaxed); max is
//   exact in any order, so every CTA gets the single-CTA scales bit for
//   bit. The slice is then quantized into shared memory, 128-byte swizzled
//   and K-major as TMA lays out a weight tile, where it stays.
// - Warps 0-7 run the products on mma.sync m16n8k32 s8 with A from
//   registers, 16 weight rows a warp: each reads its words of a packed
//   stage in the A fragment's layout from the 128-byte-swizzled ring (one
//   ldmatrix a K step; the x tiles' B fragments likewise), releases the
//   slot at once, splits each word into its low and high
//   nibbles, sign-extended bytewise (matmul_core.cuh unpack_nibbles), and
//   multiplies the low nibbles by the slice's x tile of K's first half
//   and the high ones by its second's: a byte's two nibbles sit at the same
//   fragment place of the two products, so nothing is shuffled. Products
//   are synchronous and read the registers they are given, so no split
//   waits for an earlier product, and each warp's products are
//   independent chains (the two halves, odd and even K steps, M / 8 x
//   tiles). wgmma, whose A registers must stay put until its products are
//   done, chained a chunk's unpack behind the last chunk's products in the
//   earlier int4 kernel; splitting into shared memory instead would write
//   twice the packed bytes there for products of only 8..32 x rows.
// - After each column block warps 0-7 send each int32 partial sum by
//   st.async into the CTA that owns its column (1/c of a block each);
//   warps 8-11 there sum the cluster's partials (exact in any order) and
//   run kernel 6's epilogue while warps 0-7 go on with the next block. Buffers
//   are double: a CTA sends into one again after every owner has said, by a
//   relaxed remote arrive, that it read it.
// Rows past M and K past its end are zero in the quantized slice, weight
// rows past N and packed bytes past K/2 zero-filled by TMA (a zero byte
// unpacks to two zero weights) and columns past N masked on store. No host
// padding.
#include "matmul_core.cuh"
#include "sm90_core.cuh"

#include <mutex>

namespace {

using namespace ivlm;
using namespace ivlm::sm90;

constexpr int kBN = 128;         // output columns (weight rows) a block
constexpr int kMP = 32;          // rows of x at most
constexpr int kChunk = 128;      // packed bytes a weight row a stage
constexpr int kThreads = 416;    // warps 0-7 products, 8-11 sums, 12 loads
constexpr int kLoaderWarp = 12;
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kMinStages = 4, kMaxStages = 8;
constexpr int kPBytes = kBN * kChunk;  // a packed stage: 16 KB
constexpr int kLoads = 8;              // x vectors in flight a lane
// named barriers: the sum warps, warps 0-7, warps 0-11 (the rows' scales
// are set)
constexpr int kBarSum = 1, kBarWork = 2, kBarScales = 3;

// The cluster barrier's arrival without release: the arriving thread's
// earlier writes are not made visible by it (the barriers' init fence does
// that), so it need not wait for the SM's loads in flight.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// The four 8 x 8 b16 matrices at the lanes' row addresses (lanes 8 i ..
// 8 i + 7 give matrix i's rows): each lane gets row lane / 4, bytes
// 4 (lane % 4) .. + 3 of each, the mma A fragment's words of a 16 x 32 int8
// tile, or two B fragments'.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b, mma.sync m16n8k32 s8 x s8 -> s32: a the 16 x 32 A fragment
// (a[0] row g bytes 4 t.., a[1] row g + 8, a[2] and a[3] the same rows at
// bytes 16 + 4 t..), b0 and b1 the 32 x 8 B fragment (column g, bytes 4 t..
// and 16 + 4 t..), d rows g and g + 8, columns 2 t and 2 t + 1.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory from a 1024-byte boundary: the packed ring (`stages` x 16
// KB), the quantized x slice (2 halves x
// `chunks` tiles of `np` rows x 128 bytes), two buffers that receive the
// cluster's partial sums of this CTA's columns (up to np x 136 ints), the
// barriers (full and empty a stage, ready and freed a buffer, the absmax
// exchange), the cluster's partial absmax (8 x 32) and the rows' inv and
// x_scale. ops/int4_matmul.py:decode_smem_bytes is the same sum.
struct Smem {
  int stages, chunks, np;
  __host__ __device__ int xq() const { return stages * kPBytes; }
  __host__ __device__ int part() const { return xq() + 2 * chunks * np * kChunk; }
  __host__ __device__ int part_bytes() const { return np * (kBN + 8) * 4; }
  __host__ __device__ int bar() const { return part() + 2 * part_bytes(); }
  __host__ __device__ int rows() const { return bar() + (2 * kMaxStages + 5) * 8; }
  __host__ __device__ int bytes() const {
    return 1024 + rows() + (kMaxCluster + 2) * kMP * 4;
  }
};

struct Args {
  const float* w_scale;  // (N,)
  const float* rf;       // (K,)
  void* out;             // (M, N) bf16 or f32
  int out_f32, M, N, K;
};

template <typename TX, int NP>
__global__ void __launch_bounds__(kThreads, 1)
    int4_splitk_kernel(const __grid_constant__ CUtensorMap tw,
                       const TX* __restrict__ x, Args a, Smem L) {
  constexpr int VEC = XVec<TX>::kN;  // x values a 16-byte vector
  constexpr int kQ = NP * kChunk;    // a quantized x chunk
  constexpr int NT = NP / 8;         // 8-row tiles of x in the products
  const int KW = a.K / 2;            // packed bytes a weight row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem;
  unsigned char* xq = smem + L.xq();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar());
  uint64_t* empty = full + kMaxStages;
  uint64_t* ready = empty + kMaxStages;  // a block's partial sums received
  uint64_t* freed = ready + 2;           // ... and read by their owners
  uint64_t* amax_bar = freed + 2;        // the cluster's partial absmax
  float* amax_all = reinterpret_cast<float*>(smem + L.rows());  // [rank][m]
  float* inv_s = amax_all + kMaxCluster * kMP;
  float* xs_s = inv_s + kMP;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cs = gridDim.x;  // the cluster spans the grid's x
  const int S = L.stages;
  const uint32_t rank = cluster_rank();
  const int nch = (KW + kChunk - 1) / kChunk;
  const int c_lo = rank * nch / cs, nloc = (rank + 1) * nch / cs - c_lo;
  // this cluster's column blocks: blockIdx.y, + gridDim.y, ...
  const int nblocks = ((a.N + kBN - 1) / kBN - blockIdx.y + gridDim.y - 1) /
                      gridDim.y;
  const int steps = nblocks * nloc;  // the ring's stream of (block, chunk)

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);   // the loader's arrival with its bytes
      mbar_init(&empty[s], 8);  // each product warp's, after its reads
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&ready[b], 1);   // the owner's own arrival, with the bytes
      mbar_init(&freed[b], cs);  // one arrival an owner of the cluster
    }
    mbar_init(amax_bar, 1);  // this CTA's arrival, with every CTA's bytes
    fence_barrier_init();
  }
  for (int i = tid; i < 2 * L.chunks * kQ / 16; i += kThreads)  // zeros past
    reinterpret_cast<uint4*>(xq)[i] = make_uint4(0u, 0u, 0u, 0u);  // M and K
  __syncthreads();
  // every barrier of the cluster exists before anyone signals a peer's
  // (cluster_wait, below, before the first remote signal); the arrival is
  // relaxed, so it waits for no load in flight
  cluster_arrive_relaxed();

  if (warp == kLoaderWarp) {
    // ---- the loader: the weight stream, from the start
    auto issue = [&](int g) {  // stream step g into slot g % S
      const int s = g % S;
      const int n0 = (blockIdx.y + (g / nloc) * gridDim.y) * kBN;
      mbar_arrive_expect_tx(&full[s], kPBytes);
      tma_load_2d(ring + s * kPBytes, &tw, &full[s], (c_lo + g % nloc) * kChunk,
                  n0);
    };
    if (lane == 0)
      for (int g = 0; g < steps; ++g) {
        if (g >= S) mbar_wait(&empty[g % S], ((g / S) & 1) ^ 1);
        issue(g);
      }
    return;
  }
  if (warp >= 8) {
    // ---- the sum warps: wait out the cluster barrier (they signal peers),
    // then each column block's partial sums of this CTA's columns
    cluster_wait();
    bar_sync(kBarScales, 384);
    const int lo = rank * kBN / cs, cnt = (rank + 1) * kBN / cs - lo;
    const int cmax = (kBN + cs - 1) / cs;
    const int st = tid - 256;  // 0..127
    for (int j = 0; j < nblocks; ++j) {
      uint64_t* bar = &ready[j & 1];
      if (st == 0) mbar_arrive_expect_tx(bar, cs * a.M * cnt * 4);
      mbar_wait(bar, (j >> 1) & 1);
      const int n0 = (blockIdx.y + j * gridDim.y) * kBN + lo;
      const int* buf = reinterpret_cast<const int*>(
          smem + L.part() + (j & 1) * L.part_bytes());
      for (int i = st; i < cnt * a.M; i += 128) {
        const int m = i / cnt, nl = i % cnt, gn = n0 + nl;
        if (gn >= a.N) continue;
        int sum = 0;
        for (int q = 0; q < cs; ++q) sum += buf[(q * NP + m) * cmax + nl];
        const float v = rescale(sum, xs_s[m], a.w_scale[gn], 0.f, false, kNone);
        const size_t o = (size_t)m * a.N + gn;
        if (a.out_f32)
          static_cast<float*>(a.out)[o] = v;
        else
          static_cast<bf16*>(a.out)[o] = __float2bfloat16_rn(v);
      }
      bar_sync(kBarSum, 128);  // the sums above used every value read
      if (st == 0)
        for (int q = 0; q < cs; ++q) mbar_arrive_remote(&freed[j & 1], q);
    }
    return;
  }

  // ---- warps 0-7: the slice's partial row absmax of x * rf. Warp w takes
  // rows w, w + 8, ..., its lanes 32 vectors of a row at a time: item f is
  // row w + 8 (f / G), vectors (f % G) 32 + lane, of the G a row. A batch of
  // kLoads items is in flight at once; where one batch holds all, its
  // products are quantized after the exchange without reading x again.
  // The slice's vectors are the first piece's nv, then the second's.
  const int k_lo = c_lo * kChunk, k_hi = min((c_lo + nloc) * kChunk, KW);
  const int nv = (k_hi - k_lo) / VEC, nvt = 2 * nv;
  const int groups = (nvt + 31) / 32;
  const int items = (warp < a.M ? (a.M - warp + 7) / 8 : 0) * groups;
  // vector `col` of the slice: its half of K and its column there
  auto half_of = [&](int col) { return col >= nv ? 1 : 0; };
  auto x_col = [&](int col) {
    return half_of(col) * KW + k_lo + (col - half_of(col) * nv) * VEC;
  };
  float xr[kLoads][VEC];  // x * rf of a batch
  int r0 = 0, g0 = 0;     // item f0's row and vector group
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
    uint4 v[kLoads];
    float4 f[kLoads][VEC / 4];
    int r = r0, g = g0;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int col = g * 32 + lane;
      const bool in = f0 + u < items && col < nvt;
      const int k = in ? x_col(col) : 0;
      v[u] = in ? *reinterpret_cast<const uint4*>(x + (size_t)r * a.K + k)
                : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q)
        f[u][q] = in ? reinterpret_cast<const float4*>(a.rf + k)[q]
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      step(r, g);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q) {
        xr[u][4 * q] = __fmul_rn(XVec<TX>::get(v[u], 4 * q), f[u][q].x);
        xr[u][4 * q + 1] = __fmul_rn(XVec<TX>::get(v[u], 4 * q + 1), f[u][q].y);
        xr[u][4 * q + 2] = __fmul_rn(XVec<TX>::get(v[u], 4 * q + 2), f[u][q].z);
        xr[u][4 * q + 3] = __fmul_rn(XVec<TX>::get(v[u], 4 * q + 3), f[u][q].w);
      }
  };
  // each lane's max over its vectors of the warp's rows (row w + 8 i in
  // slot i), then one warp max a row
  float amax_r[kMP / 8];
#pragma unroll
  for (int i = 0; i < kMP / 8; ++i) amax_r[i] = 0.f;
  for (int f0 = 0; f0 < items; f0 += kLoads) {
    first(f0);
    load(f0);
    int r = r0, g = g0;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const float m = vals_amax(xr[u], 0.f);  // zeros past the items
#pragma unroll
      for (int i = 0; i < kMP / 8; ++i)
        if (warp + 8 * i == r) amax_r[i] = fmaxf(amax_r[i], m);
      step(r, g);
    }
  }
#pragma unroll
  for (int i = 0; i < kMP / 8; ++i) amax_r[i] = warp_max(amax_r[i]);
  cluster_wait();  // every CTA's barriers exist
  // each row's partial into slot `rank` of every CTA of the cluster, where
  // the bytes complete the absmax barrier
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < kMP / 8; ++i) {
      const int m = warp + 8 * i;
      if (m < a.M)
        for (int q = 0; q < cs; ++q)
          st_async_s32(cluster_addr(&amax_all[rank * kMP + m], q),
                       __float_as_int(amax_r[i]), cluster_addr(amax_bar, q));
    }
  if (tid == 0) mbar_arrive_expect_tx(amax_bar, cs * a.M * 4);
  mbar_wait(amax_bar, 0);
  if (tid < a.M) {
    float amax = 0.f;
    for (int q = 0; q < cs; ++q) amax = fmaxf(amax, amax_all[q * kMP + tid]);
    row_scales(amax, inv_s[tid], xs_s[tid]);
  }
  bar_sync(kBarWork, 256);
  bar_arrive(kBarScales, 384);  // the sum warps may read x_scale

  // ---- the slice quantized into shared memory, 128-byte swizzled, the
  // second half's pieces in tiles `chunks` on
  for (int f0 = 0; f0 < items; f0 += kLoads) {
    if (items > kLoads) {  // else xr holds the one batch
      first(f0);
      load(f0);
    }
    int r = r0, g = g0;
#pragma unroll
    for (int u = 0; u < kLoads; ++u, step(r, g)) {
      const int col = g * 32 + lane;
      if (f0 + u < items && col < nvt) {
        const int h = half_of(col), k = (col - h * nv) * VEC;
        const uint2 q = quant_vals(xr[u], inv_s[r]);
        unsigned char* p = xq + (h * L.chunks + k / kChunk) * kQ +
                           sw128_offset(r, k % kChunk);
        if constexpr (VEC == 8) {
          *reinterpret_cast<uint2*>(p) = q;
        } else {
          *reinterpret_cast<uint32_t*>(p) = q.x;
        }
      }
    }
  }
  bar_sync(kBarWork, 256);

  // ---- the column blocks. Warp w multiplies weight rows 16 w .. 16 w + 15
  // of block j's chunks and sends each partial sum by st.async into buffer
  // j % 2 of the CTA that owns its column (CTA r owns columns [128 r / c,
  // 128 (r + 1) / c) of a block), where it lands on barrier `ready`; the
  // sum warps there add the cluster's partials of their columns, write the
  // output and arrive at `freed` in every CTA, while warps 0-7 go on with
  // block j + 1. A CTA sends into a buffer again (block j + 2) once `freed`
  // says every owner has read it.
  const int cmax = (kBN + cs - 1) / cs;  // columns a CTA owns at most
  // [low, high nibbles][K step parity][8-row tile of x]: independent chains
  int acc[2][2][NT][4];
  const int gr = lane >> 2, t = lane & 3;
  // this lane's ldmatrix rows: A (weight rows 16 warp + these) and B (x
  // rows 8 nt + lane % 8, of K's first half for lanes 0-15)
  const int a_row = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_col = 16 * (lane >> 4), b_col = 16 * ((lane >> 3) & 1);
  const unsigned char* xt = xq + (lane >> 4) * L.chunks * kQ;
  for (int j = 0; j < nblocks; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[h][p][nt][e] = 0;
    for (int c = 0; c < nloc; ++c) {
      const int g = j * nloc + c, s = g % S;
      mbar_wait(&full[s], (g / S) & 1);
      // the warp's A fragments of packed chunk c, one ldmatrix a K step
      const uint32_t wt = smem_addr(ring + s * kPBytes);
      uint32_t pk[kChunk / 32][4];
#pragma unroll
      for (int kk = 0; kk < kChunk / 32; ++kk)
        ldsm_x4(wt + sw128_offset(a_row, 32 * kk + a_col), pk[kk]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp's reads are done
      const uint32_t xb = smem_addr(xt + c * kQ);
#pragma unroll
      for (int kk = 0; kk < kChunk / 32; ++kk) {
        // the x rows' B fragments for K's two halves: low b0, b1, high b0, b1
        uint32_t b[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          ldsm_x4(xb + sw128_offset(8 * nt + (lane & 7), 32 * kk + b_col),
                  b[nt]);
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) unpack_nibbles(pk[kk][i], lo[i], hi[i]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_s8(acc[0][kk & 1][nt], lo, b[nt][0], b[nt][1]);
          mma_s8(acc[1][kk & 1][nt], hi, b[nt][2], b[nt][3]);
        }
      }
    }
    if (j >= 2) mbar_wait_cluster(&freed[j & 1], ((j >> 1) - 1) & 1);
    // element e of lane (gr, t) in x tile nt: weight row
    // n = 16 w + gr + 8 (e / 2), x row m = 8 nt + 2 t + e % 2; it goes to
    // row (rank, m) of its owner q's buffer, at column n - lo(q)
    unsigned char* buf = smem + L.part() + (j & 1) * L.part_bytes();
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int n = 16 * warp + gr + 8 * e2;
      const int q = ((n + 1) * cs - 1) / kBN;
      const int nl = n - q * kBN / cs;
      const uint32_t bar = cluster_addr(&ready[j & 1], q);
      const uint32_t row0 = cluster_addr(buf, q) + (rank * NP * cmax + nl) * 4;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int m = 8 * nt + 2 * t + e1;
          const int e = 2 * e2 + e1;
          if (m < a.M)
            st_async_s32(row0 + m * cmax * 4,
                         acc[0][0][nt][e] + acc[0][1][nt][e] +
                             acc[1][0][nt][e] + acc[1][1][nt][e],
                         bar);
        }
    }
  }
  // stay until every owner has read this CTA's last two blocks
  for (int j = max(0, nblocks - 2); j < nblocks; ++j)
    mbar_wait_cluster(&freed[j & 1], (j >> 1) & 1);
}

// The largest dynamic shared memory a block may take on a device.
inline int max_smem(int dev) {
  static int v[64] = {0};
  if (dev < 0 || dev >= 64) return 0;
  if (v[dev] == 0)
    cudaDeviceGetAttribute(&v[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v[dev];
}

template <typename TX, int NP>
cudaError_t launch(const void* x, const void* w, const Args& a, int cluster,
                   int clusters, int stages, cudaStream_t st) {
  static std::mutex mu;
  static bool set[64] = {false};
  auto kernel = int4_splitk_kernel<TX, NP>;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  const int KW = a.K / 2;
  const int nch = (KW + kChunk - 1) / kChunk;
  const Smem L{stages, (nch + cluster - 1) / cluster, NP};
  if (L.bytes() > max_smem(dev)) return cudaErrorInvalidValue;
  CUtensorMap tw;
  const cuuint64_t dw[2] = {(cuuint64_t)KW, (cuuint64_t)a.N};
  const cuuint64_t sw[1] = {(cuuint64_t)KW};
  const cuuint32_t bw[2] = {kChunk, kBN};
  if (!encode_sw128(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, dw, sw, bw))
    return cudaErrorInvalidValue;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!set[dev]) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem(dev));
      if (e != cudaSuccess) return e;
      set[dev] = true;
    }
  }
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
  const int blocks = (a.N + kBN - 1) / kBN;
  cfg.gridDim = dim3(cluster, min(blocks, clusters), 1);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, tw, static_cast<const TX*>(x), a, L);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TX>
cudaError_t launch_rows(const void* x, const void* w, const Args& a,
                        int cluster, int clusters, int stages,
                        cudaStream_t st) {
  if (a.M <= 8) return launch<TX, 8>(x, w, a, cluster, clusters, stages, st);
  if (a.M <= 16)
    return launch<TX, 16>(x, w, a, cluster, clusters, stages, st);
  return launch<TX, 32>(x, w, a, cluster, clusters, stages, st);
}

}  // namespace

// x: (M, K) bf16 (x_f32 = 0) or f32, contiguous; w: (N, K/2) packed int4,
// contiguous; rf: (K,) f32; w_scale: (N,) f32; out: (M, N) bf16
// (out_f32 = 0) or f32. 1 <= M <= 32, K % 32 == 0, N % 8 == 0, every
// pointer 16-byte aligned; `cluster` CTAs split the K / 256 packed chunks
// (rounded up), 1 to 8 and at most that many, `clusters` clusters walk the
// column blocks, over a ring of `stages` (4 to 8) packed stages
// (ops/int4_matmul.py:decode_plan). The quantized slice, the partial-sum
// buffers and the ring must fit the block's shared memory. Returns the
// launch status (0 = launched).
extern "C" int ivlm_int4_matmul(const void* x, int x_f32, const void* w,
                                const void* rf, const void* w_scale,
                                void* out, int out_f32, int M, int N, int K,
                                int cluster, int clusters, int stages,
                                void* stream) {
  if (M <= 0 || M > kMP || N <= 0 || K <= 0 || K % 32 != 0 || N % 8 != 0 ||
      rf == nullptr || cluster < 1 || cluster > kMaxCluster ||
      cluster > (K / 2 + kChunk - 1) / kChunk || clusters < 1 ||
      stages < kMinStages || stages > kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(w_scale),
               static_cast<const float*>(rf), out, out_f32, M, N, K};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_f32 ? launch_rows<float>(x, w, a, cluster, clusters, stages, st)
            : launch_rows<bf16>(x, w, a, cluster, clusters, stages, st);
  return static_cast<int>(err);
}

// The clusters of `cluster` CTAs the decode kernel can hold on the current
// device at once for M rows, each CTA taking `smem` bytes of shared memory
// (each CTA an SM, the cluster inside one GPC: on an H100 fewer than SMs /
// cluster, and not in proportion), or 0 where that does not fit: what
// ops/int4_matmul.py:decode_plan plans with.
extern "C" int ivlm_int4_matmul_clusters(int cluster, int M, int smem) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (M <= 0 || M > kMP || cluster < 1 || cluster > kMaxCluster ||
      smem <= 0 || smem > max_smem(dev))
    return 0;
  const int np = M <= 8 ? 8 : M <= 16 ? 16 : 32;
  const void* kernel =
      np == 8 ? (const void*)int4_splitk_kernel<bf16, 8>
              : np == 16 ? (const void*)int4_splitk_kernel<bf16, 16>
                         : (const void*)int4_splitk_kernel<bf16, 32>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           max_smem(dev)) != cudaSuccess)
    return 0;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess)
    return 0;
  return clusters;
}

IVLM_EXPORT_ERROR_STRING(ivlm_int4_matmul)
