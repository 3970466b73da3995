// What the head-dim-16 flash kernels on Hopper (sm_90a) share: the
// forward (flash_fwd_d16_sm90.cuh) and the backward
// (flash_bwd_d16_sm90.cuh). At D = 16 a row of q, k, v, o or dO is 32
// bytes, one k16 step of a bf16 wgmma, so every tile lives in shared
// memory in the 32-byte swizzle and every logit product is one wgmma
// m64nNk16 with both operands K-major there.
#pragma once

#include "sm90_core.cuh"

namespace ivlm {
namespace d16_sm90 {

using namespace ivlm::sm90;

// S = A B^T, m64nNk16, both operands from shared memory (K-major, rows of
// 32 bytes in the 32-byte swizzle), overwriting d: one function a width
// N = 16 .. 128. The forward's S = Q K^T; the backward's S = Q K^T and
// dP = dO V^T (query rows by keys) and S^T = K Q^T and dP^T = V dO^T (keys
// by query rows)
#define IVLM_D16_OUT8(d, i)                                                 \
  "=f"(d[i + 0]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]),           \
      "=f"(d[i + 4]), "=f"(d[i + 5]), "=f"(d[i + 6]), "=f"(d[i + 7])
#define IVLM_D16_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define IVLM_D16_R16 IVLM_D16_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define IVLM_D16_R24 IVLM_D16_R16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define IVLM_D16_R32 IVLM_D16_R24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define IVLM_D16_R40 IVLM_D16_R32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define IVLM_D16_R48 IVLM_D16_R40 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define IVLM_D16_R56 IVLM_D16_R48 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define IVLM_D16_R64 IVLM_D16_R56 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define IVLM_D16_C8(d) IVLM_D16_OUT8(d, 0)
#define IVLM_D16_C16(d) IVLM_D16_C8(d), IVLM_D16_OUT8(d, 8)
#define IVLM_D16_C24(d) IVLM_D16_C16(d), IVLM_D16_OUT8(d, 16)
#define IVLM_D16_C32(d) IVLM_D16_C24(d), IVLM_D16_OUT8(d, 24)
#define IVLM_D16_C40(d) IVLM_D16_C32(d), IVLM_D16_OUT8(d, 32)
#define IVLM_D16_C48(d) IVLM_D16_C40(d), IVLM_D16_OUT8(d, 40)
#define IVLM_D16_C56(d) IVLM_D16_C48(d), IVLM_D16_OUT8(d, 48)
#define IVLM_D16_C64(d) IVLM_D16_C56(d), IVLM_D16_OUT8(d, 56)
// REGS lists the N / 2 accumulators; A, B and P are the operand numbers of
// the two descriptors and the scale-d flag that follow them
#define IVLM_D16_S_SET(NN, REGS, A, B, P, CONS)                              \
  __device__ __forceinline__ void s_set(float(&d)[NN / 2], uint64_t a,      \
                                        uint64_t b) {                       \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"             \
                 "wgmma.mma_async.sync.aligned.m64n" #NN                    \
                 "k16.f32.bf16.bf16 {" REGS "}, " A ", " B                  \
                 ", p, 1, 1, 0, 0;\n}\n"                                    \
                 : CONS(d)                                                  \
                 : "l"(a), "l"(b), "r"(0));                                 \
  }
IVLM_D16_S_SET(16, IVLM_D16_R8, "%8", "%9", "%10", IVLM_D16_C8)
IVLM_D16_S_SET(32, IVLM_D16_R16, "%16", "%17", "%18", IVLM_D16_C16)
IVLM_D16_S_SET(48, IVLM_D16_R24, "%24", "%25", "%26", IVLM_D16_C24)
IVLM_D16_S_SET(64, IVLM_D16_R32, "%32", "%33", "%34", IVLM_D16_C32)
IVLM_D16_S_SET(80, IVLM_D16_R40, "%40", "%41", "%42", IVLM_D16_C40)
IVLM_D16_S_SET(96, IVLM_D16_R48, "%48", "%49", "%50", IVLM_D16_C48)
IVLM_D16_S_SET(112, IVLM_D16_R56, "%56", "%57", "%58", IVLM_D16_C56)
IVLM_D16_S_SET(128, IVLM_D16_R64, "%64", "%65", "%66", IVLM_D16_C64)
#undef IVLM_D16_S_SET
#undef IVLM_D16_OUT8
#undef IVLM_D16_R8
#undef IVLM_D16_C8
#undef IVLM_D16_R16
#undef IVLM_D16_C16
#undef IVLM_D16_R24
#undef IVLM_D16_C24
#undef IVLM_D16_R32
#undef IVLM_D16_C32
#undef IVLM_D16_R40
#undef IVLM_D16_C40
#undef IVLM_D16_R48
#undef IVLM_D16_C48
#undef IVLM_D16_R56
#undef IVLM_D16_C56
#undef IVLM_D16_R64
#undef IVLM_D16_C64

// brings a tensor map into the cache before its first TMA load
__device__ __forceinline__ void prefetch_tmap(const CUtensorMap* m) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(m))
               : "memory");
}

// The byte offset of 16-byte chunk c (0 or 1) of row r in a tile of
// 32-byte rows in the 32-byte swizzle, as TMA writes it (the tile starts on
// a 256-byte boundary): address bit 4 flips with bit 7, so rows 4-7 of
// every group of 8 hold their two chunks swapped.
__device__ __forceinline__ uint32_t sw32_offset(int r, int c) {
  return static_cast<uint32_t>(r * 32 + ((c ^ ((r >> 2) & 1)) << 4));
}

// A 4-D tensor map over a (B, H, L, 16) bf16 view with element strides
// s[0] (batch), s[1] (head), s[2] (row), multiples of 8, read as (head-dim
// column, row, head, batch) in boxes of `rows` rows of `heads` heads, 32-byte
// swizzled: rows past L are zero-filled. Returns false if the encode
// refuses.
inline bool view_map(CUtensorMap* map, const void* base, const long long* s,
                     int B, int H, int L, int rows, int heads) {
  const cuuint64_t dims[4] = {16, (cuuint64_t)L, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s[2] * 2, (cuuint64_t)s[1] * 2,
                                 (cuuint64_t)s[0] * 2};
  const cuuint32_t box[4] = {16, (cuuint32_t)rows, (cuuint32_t)heads, 1};
  return encode_swizzled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base,
                         dims, strides, box, CU_TENSOR_MAP_SWIZZLE_32B);
}

}  // namespace d16_sm90
}  // namespace ivlm
