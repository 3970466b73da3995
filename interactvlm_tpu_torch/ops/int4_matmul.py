"""Int4-weight matmul on the card: the packed nibbles read by two kernels of
their own, with the row factor folded into the row quantize.

``int4_matmul_fused(x, packed, col_scale, row_factor)`` computes
``ops/quant.py:int4_matmul`` for a packed split-half int4 weight (N, K/2)
(byte j of a row holds column j in its low nibble and column j + K/2 in its
high one, ``quant.pack_int4``), per-column f32 scales (N,) and the rank-1
row factor (K,): xr = f32(x) * rf; per row amax = max|xr|, inv = 127 /
max(amax, 1e-8), x_scale = max(amax, 1e-8) / 127 (IEEE divisions), xq =
clip(rint(xr * inv), -127, 127) half to even; acc = sum_{j < K/2} xq[j]
lo[j] + xq[K/2 + j] hi[j] exactly; out = (f32(acc) * x_scale) * col_scale,
cast to the output dtype.

Two routes by shape alone (``int4_route``), as ``int8_route`` picks kernel
6's: up to ``ONE_LAUNCH_MAX_ROWS`` rows (decode and the lm_head) one launch
of the decode kernel ``csrc/int4_matmul.cu``, its K split and its column
blocks planned per shape here (``decode_plan``); above, two passes: kernel
7 with the row factor (``int8_matmul.quantize_rows``), then the int4 GEMM
``csrc/int4_gemm_sm90.cu`` (``int4_gemm``). The row-parallel int4 linear
takes kernel 7's given-scale route with the row factor, then ``int4_gemm``
(``ops/quant.py:int4_matmul_row_parallel``).

The sum is exact and the epilogue is kernel 6's, so both routes give the
bits of the route the card took before them, the unpack into a transient
(N, K) int8 weight and kernel 6 on f32 x * rf
(``int4_matmul_unpack_route``, which tests and ``chip_smoke.py`` call for
that check and nothing on a serving path does). These kernels replace no
Pallas kernel: the JAX package leaves the int4 product to XLA.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from interactvlm_tpu_torch.ops import _cuda
from interactvlm_tpu_torch.ops.int8_matmul import (
    K_CHUNK,
    MAX_CLUSTER,
    ONE_LAUNCH_MAX_ROWS,
    X_DTYPES,
    int8_matmul_fused,
    int8_matmul_fused_plain,
    int8_matmul_prequant_plain,
    quantize_rows,
)
from interactvlm_tpu_torch.ops.quant import unpack_int4

# The decode kernel (csrc/int4_matmul.cu): blocks of 128 output columns,
# packed chunks of 128 bytes a weight row (256 K values), a ring of 4 to 8
# packed stages of 16 KB.
DECODE_BLOCK, DECODE_STAGE = 128, 128 * K_CHUNK
DECODE_MIN_STAGES, DECODE_MAX_STAGES = 4, 8
# What a block may take on an H100, and the decode kernel's clusters of
# 1..8 CTAs an H100 80GB HBM3 holds at once (a cluster stays inside one
# GPC, so fewer than 132 / size from 3 on; ivlm_int4_matmul_clusters): the
# plan's defaults where no card is asked.
H100_SMEM = 232448
H100_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15)
# The decode kernel's time in µs on an H100 80GB HBM3 at 700 W as a
# function of its split, fitted to every split at LLaMA-7B's decode shapes
# at 8 and 32 rows (``chip_ab.py``'s ``decode_plans``): a fixed part, a
# column block's (the partial sums' exchange), a packed chunk's a column
# block (its products, more with more rows) and a chunk's of the slice
# (the x rows read and quantized once): DECODE_COST[0] + rounds
# DECODE_COST[1] + rounds chunks (DECODE_COST[2] + r DECODE_COST[3]) +
# chunks (DECODE_COST[4] + r DECODE_COST[5]), r the rows padded / 8. It
# picks the fastest split of the sweep at 6 of its 7 shapes, the seventh
# within 4 %.
DECODE_COST = (5.62, 0.42, 0.243, 0.183, 0.094, 0.324)


def decode_smem_bytes(rows: int, chunks: int, stages: int) -> int:
    """The decode kernel's shared memory (its ``Smem::bytes``) for x padded
    to ``rows`` (8, 16 or 32) and ``chunks`` packed chunks a CTA: the ring,
    both halves of the quantized slice, two partial-sum buffers of rows x
    136 ints, 21 barriers, 10 x 32 floats, from a 1024-byte boundary."""
    return (1024 + stages * DECODE_STAGE + 2 * chunks * rows * K_CHUNK
            + 2 * rows * (DECODE_BLOCK + 8) * 4 + 21 * 8 + 10 * 32 * 4)


def decode_stages(rows: int, chunks: int, smem: int = H100_SMEM) -> int:
    """The ring the decode kernel takes beside a slice of ``chunks`` packed
    chunks at ``rows`` rows in ``smem`` bytes: as many 16 KB stages as fit,
    up to 8; 0 where fewer than 4 fit."""
    stages = min(DECODE_MAX_STAGES,
                 (smem - decode_smem_bytes(rows, chunks, 0)) // DECODE_STAGE)
    return stages if stages >= DECODE_MIN_STAGES else 0


def padded_rows(M: int) -> int:
    """The decode products' width for M rows: 8, 16 or 32."""
    return 8 if M <= 8 else 16 if M <= 16 else 32


def _max_chunks(smem: int = H100_SMEM) -> int:
    """Packed chunks a CTA may hold at 32 rows beside the fewest stages."""
    c = 0
    while decode_smem_bytes(32, c + 1, DECODE_MIN_STAGES) <= smem:
        c += 1
    return c


# Up to this K every row count up to 32 has a decode plan on an H100: 8
# CTAs of 15 packed chunks (30720).
ONE_LAUNCH_MAX_K = MAX_CLUSTER * _max_chunks() * 2 * K_CHUNK


@functools.lru_cache(maxsize=None)
def decode_plan(M: int, N: int, K: int, clusters=H100_CLUSTERS,
                smem: int = H100_SMEM):
    """The decode kernel's launch for M rows, N output columns and K values
    on a card that holds ``clusters[c - 1]`` clusters of c CTAs at once and
    gives a block ``smem`` bytes of shared memory: (cluster, clusters,
    stages). ``cluster`` CTAs split the n = K / 256 packed chunks (rounded
    up), CTA r taking [r n / c, (r + 1) n / c); ``clusters`` clusters walk
    the N / 128 column blocks (rounded up), no more than the card holds, so
    every CTA runs in the first wave. The plan takes the least time by
    ``DECODE_COST``'s model, the smallest cluster among equals, among the
    splits whose quantized slice leaves room for at least 4 ring stages;
    ``stages`` is the ring that fits (``decode_stages``). Raises where no
    split fits."""
    nch = -(-(K // 2) // K_CHUNK)
    blocks = -(-N // DECODE_BLOCK)
    rows = padded_rows(M)
    t0, t_block, t_chunk, t_chunk_row, t_slice, t_slice_row = DECODE_COST
    r = rows // 8
    best = None
    for cs in range(1, min(MAX_CLUSTER, nch) + 1):
        chunks = -(-nch // cs)
        stages = decode_stages(rows, chunks, smem)
        if not stages or clusters[cs - 1] < 1:
            continue
        n = min(blocks, clusters[cs - 1])
        rounds = -(-blocks // n)
        cost = (t0 + rounds * t_block + rounds * chunks
                * (t_chunk + r * t_chunk_row)
                + chunks * (t_slice + r * t_slice_row))
        if best is None or cost < best[0]:
            best = (cost, cs, n, stages)
    if best is None:
        raise ValueError(f"int4_matmul: no decode split of K={K} fits "
                         f"{smem} bytes at {M} rows")
    return best[1:]


@functools.lru_cache(maxsize=None)
def _card_smem(index: int) -> int:
    return torch.cuda.get_device_properties(
        index).shared_memory_per_block_optin


@functools.lru_cache(maxsize=None)
def _card_clusters(index: int, rows: int, K: int):
    """The decode kernel's clusters of 1..8 CTAs that CUDA device ``index``
    holds at once for ``rows`` rows of K values, each CTA with the shared
    memory of its slice and ring (0 where the slice does not fit), from the
    occupancy API."""
    f = _cuda.load("int4_matmul").ivlm_int4_matmul_clusters
    f.restype, f.argtypes = ctypes.c_int, [ctypes.c_int] * 3
    smem, nch = _card_smem(index), -(-(K // 2) // K_CHUNK)
    held = []
    with torch.cuda.device(index):
        for cs in range(1, MAX_CLUSTER + 1):
            chunks = -(-nch // cs)
            stages = decode_stages(rows, chunks, smem)
            held.append(f(cs, rows, decode_smem_bytes(rows, chunks, stages))
                        if stages and cs <= nch else 0)
    return tuple(held)


@functools.lru_cache(maxsize=None)
def decode_plan_on_card(M: int, N: int, K: int, index: int):
    """``decode_plan`` with what CUDA device ``index`` holds and gives,
    once a shape: a decode call's host time is most of its time."""
    return decode_plan(M, N, K, _card_clusters(index, padded_rows(M), K),
                       _card_smem(index))


def unpacked(packed):
    """The (N, K) int8 weight of a packed (N, K/2) one."""
    return torch.cat(unpack_int4(packed), dim=1)


def int4_matmul_fused_plain(x, packed, col_scale, row_factor, out_dtype=None):
    """Plain version of both routes: the unpack, then kernel 6's plain
    version on the f32 products x * rf."""
    xr = x.float() * row_factor
    return int8_matmul_fused_plain(xr, unpacked(packed), col_scale,
                                   out_dtype=out_dtype or x.dtype)


def int4_matmul_unpack_route(x, packed, col_scale, row_factor,
                             out_dtype=None):
    """The card's int4 route before these kernels: the row factor as a
    separate f32 tensor, the unpack into a transient (N, K) int8 copy, then
    kernel 6 (``int8_matmul_fused``). Kept for the bit-for-bit check and the
    same-call A/B only; ``Int4Linear`` never reaches it."""
    xr = x.float() * row_factor
    return int8_matmul_fused(xr, unpacked(packed), col_scale,
                             out_dtype=out_dtype or x.dtype)


def int4_route(M: int, K: int = 0) -> str:
    """The route of ``int4_matmul_fused`` for M rows of K values:
    "one_launch" (the decode kernel) or "two_pass" (kernel 7 with the row
    factor, then ``int4_gemm``)."""
    one = M <= ONE_LAUNCH_MAX_ROWS and K <= ONE_LAUNCH_MAX_K
    return "one_launch" if one else "two_pass"


def _check(x, packed, col_scale, row_factor, out_dtype):
    K = x.shape[-1]
    N = packed.shape[0]
    if x.dtype not in X_DTYPES or out_dtype not in X_DTYPES:
        raise ValueError(f"int4_matmul: x and the output must be bf16 or f32, "
                         f"got {x.dtype} -> {out_dtype}")
    if packed.dtype != torch.int8 or packed.dim() != 2 or \
            2 * packed.shape[1] != K:
        raise ValueError(f"int4_matmul: packed weight must be int8 (N, "
                         f"{K // 2}), got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    if K % 32 or N % 8:
        raise ValueError(f"int4_matmul: K must be a multiple of 32 and N of "
                         f"8, got K={K} N={N}")
    if col_scale.shape != (N,) or row_factor.shape != (K,):
        raise ValueError(f"int4_matmul: scales ({N},) and row factor ({K},), "
                         f"got {tuple(col_scale.shape)} and "
                         f"{tuple(row_factor.shape)}")
    _cuda.require_kernel_inputs("int4_matmul", x, dtype=x.dtype)
    _cuda.require_kernel_inputs("int4_matmul", packed, dtype=torch.int8)
    _cuda.require_kernel_inputs("int4_matmul", col_scale, row_factor,
                                dtype=torch.float32)
    if len({t.device for t in (x, packed, col_scale, row_factor)}) != 1:
        raise ValueError("int4_matmul: all inputs must be on one CUDA device")


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def int4_decode(x, packed, col_scale, row_factor, out_dtype, plan=None):
    """One launch of the decode kernel on checked CUDA inputs (x (M, K) with
    M <= 32): ``plan`` (cluster, clusters) overrides ``decode_plan``'s for
    the card, with the ring that fits. Every plan gives the same bits.
    Counts nothing:
    ``int4_matmul_fused`` is the counted wrapper; this is its launcher,
    also called to time a plan."""
    K, N = x.shape[-1], packed.shape[0]
    M = x.numel() // K
    if plan is None:
        plan = decode_plan_on_card(M, N, K, x.device.index)
    else:
        nch = -(-(K // 2) // K_CHUNK)
        plan = (*plan, decode_stages(padded_rows(M), -(-nch // plan[0]),
                                     _card_smem(x.device.index)))
    out = torch.empty(*x.shape[:-1], N, dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        _cuda.launch(
            "int4_matmul", "ivlm_int4_matmul", _ARGTYPES,
            _cuda.ptr(x), int(x.dtype == torch.float32), _cuda.ptr(packed),
            _cuda.ptr(row_factor), _cuda.ptr(col_scale), _cuda.ptr(out),
            int(out_dtype == torch.float32), M, N, K, *plan,
            _cuda.stream_handle(x.device),
        )
    return out


def int4_matmul_fused(x, packed, col_scale, row_factor, out_dtype=None):
    """x (..., K) @ packed int4 W (N, K/2) -> (..., N) in ``out_dtype``
    (x's dtype by default), the row factor and the quantization of x fused.

    CPU tensors run ``int4_matmul_fused_plain``; CUDA tensors (x bf16 or
    f32 and contiguous, the packed weight int8 contiguous, f32 scales and
    row factor, K a multiple of 32, N of 8) take the route ``int4_route``
    names for their shape, or raise: there is no fallback to the unpack.
    Forward only. ``launches`` counts the calls on the card, and
    ``route_launches`` each route's."""
    _cuda.refuse_grad("int4_matmul", x)
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return int4_matmul_fused_plain(x, packed, col_scale, row_factor,
                                       out_dtype)
    _check(x, packed, col_scale, row_factor, out_dtype)
    K, N = x.shape[-1], packed.shape[0]
    M = x.numel() // K
    route = int4_route(M, K)
    if route == "two_pass":
        x_q, x_scale = quantize_rows(x.reshape(M, K), row_factor)
        out = int4_gemm(x_q, x_scale, packed, col_scale,
                        out_dtype).reshape(*x.shape[:-1], N)
    else:
        out = int4_decode(x, packed, col_scale, row_factor, out_dtype)
    int4_matmul_fused.launches += 1
    int4_matmul_fused.route_launches[route] += 1
    return out


int4_matmul_fused.launches = 0
int4_matmul_fused.route_launches = {"one_launch": 0, "two_pass": 0}


def int4_gemm_plain(x_q, x_scale, packed, col_scale, dtype=torch.bfloat16):
    """Plain version of the int4 GEMM: the unpack, then the int8 GEMM's
    plain version without a bias or activation."""
    return int8_matmul_prequant_plain(x_q, x_scale, unpacked(packed),
                                      col_scale, dtype)


_GEMM_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p])


def int4_gemm(x_q, x_scale, packed, col_scale, dtype=torch.bfloat16):
    """Pre-quantized int8 x_q (M, K) with per-row scales (M, 1) @ packed
    int4 W (N, K/2) with per-column scales (N,) -> (M, N) in ``dtype``:
    pass 2 of ``int4_matmul_fused``'s two-pass route and of the row-parallel
    int4 linear.

    CPU tensors run ``int4_gemm_plain``; CUDA tensors launch the wgmma
    kernel (contiguous int8 x_q and packed W, f32 scales, K a multiple of
    32, N of 8, ``dtype`` bf16 or f32) or raise. Forward only."""
    _cuda.refuse_grad("int4_gemm", x_scale, col_scale)
    if not x_q.is_cuda:
        return int4_gemm_plain(x_q, x_scale, packed, col_scale, dtype)
    M, K = x_q.shape
    N = packed.shape[0]
    if packed.dim() != 2 or 2 * packed.shape[1] != K or K % 32 or N % 8:
        raise ValueError(f"int4_gemm: packed weight (N, {K // 2}) with K a "
                         f"multiple of 32 and N of 8, got "
                         f"{tuple(packed.shape)}")
    if x_scale.numel() != M or col_scale.shape != (N,):
        raise ValueError(f"int4_gemm: scales ({M}, 1) and ({N},), got "
                         f"{tuple(x_scale.shape)} and "
                         f"{tuple(col_scale.shape)}")
    if dtype not in X_DTYPES:
        raise ValueError(f"int4_gemm: output {dtype}")
    _cuda.require_kernel_inputs("int4_gemm", x_q, packed, dtype=torch.int8)
    _cuda.require_kernel_inputs("int4_gemm", x_scale, col_scale,
                                dtype=torch.float32)
    out = torch.empty(M, N, dtype=dtype, device=x_q.device)
    with torch.cuda.device(x_q.device):
        _cuda.launch(
            "int4_gemm_sm90", "ivlm_int4_gemm", _GEMM_ARGTYPES,
            _cuda.ptr(x_q), _cuda.ptr(x_scale), _cuda.ptr(packed),
            _cuda.ptr(col_scale), _cuda.ptr(out), int(dtype == torch.float32),
            M, N, K, _cuda.stream_handle(x_q.device),
        )
    int4_gemm.launches += 1
    return out


int4_gemm.launches = 0
