"""Int4-weight matmul on the card: the packed nibbles read inside kernel 6's
two routes, with the row factor folded into the row quantize.

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
of ``csrc/int8_matmul.cu`` in its int4 mode; above, two passes: kernel 7
with the row factor (``int8_matmul.quantize_rows``), then the int4 GEMM
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
    one_launch_plan,
    quantize_rows,
)
from interactvlm_tpu_torch.ops.quant import unpack_int4

# The one-launch kernel's int4 mode keeps both halves of its K slice
# quantized in shared memory (2 x 32 rows x 128 bytes a packed chunk of 256
# K values) beside at least 4 ring stages: up to 15 packed chunks a CTA.
ONE_LAUNCH_MAX_K = MAX_CLUSTER * 15 * 2 * K_CHUNK


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
    "one_launch" (the one-launch kernel's int4 mode) or "two_pass" (kernel
    7 with the row factor, then ``int4_gemm``)."""
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
             + [ctypes.c_int] * 5 + [ctypes.c_void_p])


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
        out = torch.empty(*x.shape[:-1], N, dtype=out_dtype, device=x.device)
        with torch.cuda.device(x.device):
            _cuda.launch(
                "int8_matmul", "ivlm_int4_matmul", _ARGTYPES,
                _cuda.ptr(x), int(x.dtype == torch.float32), _cuda.ptr(packed),
                _cuda.ptr(row_factor), _cuda.ptr(col_scale), _cuda.ptr(out),
                int(out_dtype == torch.float32), M, N, K,
                one_launch_plan(K // 2)[0], _cuda.stream_handle(x.device),
            )
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
    32, ``dtype`` bf16 or f32) or raise. Forward only."""
    _cuda.refuse_grad("int4_gemm", x_scale, col_scale)
    if not x_q.is_cuda:
        return int4_gemm_plain(x_q, x_scale, packed, col_scale, dtype)
    M, K = x_q.shape
    N = packed.shape[0]
    if packed.dim() != 2 or 2 * packed.shape[1] != K or K % 32:
        raise ValueError(f"int4_gemm: packed weight (N, {K // 2}) with K a "
                         f"multiple of 32, got {tuple(packed.shape)}")
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
