"""Int8 quantize + matmul: the one-launch CUDA kernel ``csrc/int8_matmul.cu``
(K split over a thread-block cluster, ``one_launch_plan``),
the row quantize ``csrc/int8_prequant.cu``, the wgmma int8 GEMM
``csrc/int8_gemm_sm90.cu`` (the two-pass route's second pass and the
pre-quantized matmul), and their plain PyTorch versions.

Ports of the Pallas TPU kernels of ``interactvlm_tpu/ops/int8_matmul.py``:
``_kernel`` / ``_kernel_nobias`` (wrapper ``int8_matmul_fused``),
``_quantize_kernel`` (``quantize_rows``) and ``_mm_prequant_kernel``
(``int8_matmul_prequant``, which only the chain probe runs). The kernel
sources say what bounds each on the H100 and how its design answers that.

``int8_matmul_fused`` picks its route by the number of rows M (``int8_route``):
up to ``ONE_LAUNCH_MAX_ROWS`` (decode and the lm_head, where the host's
launches set the pace) one launch of the fused kernel; above it, or where K
exceeds ``ONE_LAUNCH_MAX_K`` (the one-launch kernel keeps its slice of the
quantized rows in shared memory), two passes, ``quantize_rows`` then
``int8_gemm``, which give the same bits.

Semantics, for x (..., K) bf16 or f32 and an int8 weight (N, K) with f32
per-column scales (N,): per row of x, amax = max|x| (in x's own type, then
f32), x_scale = max(amax, 1e-8) / 127, inv = 127 / max(amax, 1e-8),
xq = clip(round_half_even(x * inv), -127, 127); acc = xq @ Wq^T exactly (an
int32 sum); out = act(f32(acc) * x_scale * w_scale + bias) in f32, cast to
the output dtype. ``activation`` is "none", "gelu" (exact erf; the TPU
kernel's Abramowitz-Stegun polynomial is within 1.5e-7 of it) or
"gelu_tanh". A zero row writes ``act(bias)``.

This is the composition ``ops/quant.int8_matmul`` up to one point: it
multiplies by ``inv`` where the composition divides by ``x_scale``, so the
two can round an element to neighbouring integers where x * (127 / amax)
and x / (amax / 127) fall on opposite sides of a rounding tie.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from interactvlm_tpu_torch.ops import _cuda
from interactvlm_tpu_torch.ops.quant import (
    SCALE_FLOOR,
    exact_div,
    int_matmul_exact,
)

ACTIVATIONS = {"none": 0, "gelu": 1, "gelu_tanh": 2}
X_DTYPES = (torch.bfloat16, torch.float32)


def apply_activation(y, activation: str):
    if activation == "gelu":
        return 0.5 * y * (1.0 + torch.erf(y * 2.0 ** -0.5))
    if activation == "gelu_tanh":
        return F.gelu(y, approximate="tanh")
    if activation != "none":
        raise ValueError(f"int8_matmul: unknown activation {activation!r}")
    return y


def int8_matmul_fused_plain(x, w_q, w_scale, bias=None,
                            activation: str = "none", out_dtype=None):
    """Plain version of the kernel, the same arithmetic in torch: the int32
    sum is taken exactly in float64 (``quant.int_matmul_exact``)."""
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    amax = x2.abs().amax(dim=-1, keepdim=True).float().clamp_min(SCALE_FLOOR)
    x_scale = exact_div(amax, 127.0)
    inv = exact_div(127.0, amax)
    xq = torch.clamp(torch.round(x2.float() * inv), -127, 127)
    out = int_matmul_exact(xq, w_q) * x_scale * w_scale.float()
    if bias is not None:
        out = out + bias.float()
    out = apply_activation(out, activation)
    return out.to(out_dtype or x.dtype).reshape(*x.shape[:-1], w_q.shape[0])


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _check(x, w_q, w_scale, bias, activation, out_dtype):
    K = x.shape[-1]
    N = w_q.shape[0]
    if x.dtype not in X_DTYPES or out_dtype not in X_DTYPES:
        raise ValueError(f"int8_matmul: x and the output must be bf16 or f32, "
                         f"got {x.dtype} -> {out_dtype}")
    if w_q.dtype != torch.int8 or w_q.dim() != 2 or w_q.shape[1] != K:
        raise ValueError(f"int8_matmul: weight must be int8 (N, {K}), got "
                         f"{w_q.dtype} {tuple(w_q.shape)}")
    if K % 32 or N % 8:
        raise ValueError(f"int8_matmul: K must be a multiple of 32 and N of "
                         f"8, got K={K} N={N}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"int8_matmul: unknown activation {activation!r}")
    _cuda.require_kernel_inputs("int8_matmul", x, dtype=x.dtype)
    _cuda.require_kernel_inputs("int8_matmul", w_q, dtype=torch.int8)
    f32 = [w_scale] + ([bias] if bias is not None else [])
    _cuda.require_kernel_inputs("int8_matmul", *f32, dtype=torch.float32)
    for t in [w_q] + f32:
        if t.device != x.device:
            raise ValueError("int8_matmul: all inputs must be on one CUDA device")
    for t in f32:
        if t.shape != (N,):
            raise ValueError(f"int8_matmul: scale and bias must be ({N},), "
                             f"got {tuple(t.shape)}")


# Rows up to which int8_matmul_fused keeps the one-launch kernel: LLaMA
# decode (M = B = 8 or 32) and the lm_head. There the host's issue time sets
# the pace, and a second launch a linear would add to it.
ONE_LAUNCH_MAX_ROWS = 32


# The one-launch kernel's K split: 128-value chunks over a cluster of at
# most 8 CTAs (the portable cluster size), one slice each. Each CTA keeps
# its slice of the quantized rows in shared memory (32 rows x 128 bytes a
# chunk) beside a ring of at least 4 weight stages of 16 KB and two 17 KB
# buffers of partial sums, within the 227 KB a block may take: up to 31
# chunks a slice.
K_CHUNK, MAX_CLUSTER = 128, 8
ONE_LAUNCH_MAX_K = MAX_CLUSTER * 31 * K_CHUNK


@functools.lru_cache(maxsize=None)
def one_launch_plan(K: int):
    """The one-launch kernel's split of K: the cluster size and each CTA's
    half-open range of 128-value chunks, as the kernel computes them (CTA r
    of c takes chunks [r n / c, (r + 1) n / c) of the n = ceil(K / 128)),
    so every chunk once and every CTA at least one. Cached: decode asks
    for it at every linear."""
    n = -(-K // K_CHUNK)
    c = min(MAX_CLUSTER, n)
    return c, tuple((r * n // c, (r + 1) * n // c) for r in range(c))


def int8_route(M: int, K: int = 0) -> str:
    """The route of ``int8_matmul_fused`` for M rows of K values:
    "one_launch" (the fused kernel) or "two_pass" (``quantize_rows`` then
    ``int8_gemm``). Rows decide, at any K up to ``ONE_LAUNCH_MAX_K``.

    A row-parallel int8 linear (tensor parallelism, ``models/layers.py``)
    takes neither: its rank holds a slice of each row, so it quantizes with
    the whole row's absmax, all-reduced over the model ranks, through
    ``quantize_rows_given`` and then ``int8_gemm`` to an f32 partial sum,
    at every M (``ops/quant.py:row_parallel_matmul``)."""
    one = M <= ONE_LAUNCH_MAX_ROWS and K <= ONE_LAUNCH_MAX_K
    return "one_launch" if one else "two_pass"


def int8_matmul_fused(x, w_q, w_scale, bias=None, activation: str = "none",
                      out_dtype=None):
    """x (..., K) @ int8 W (N, K) -> (..., N) in ``out_dtype`` (x's dtype by
    default), with the quantization of x, the rescale, the bias and the
    activation fused.

    CPU tensors run ``int8_matmul_fused_plain``; CUDA tensors (x bf16 or f32
    and contiguous, W int8 contiguous, f32 scale and bias, K a multiple of
    32, N of 8) take the route ``int8_route`` names for their shape, or
    raise. Both raise under grad, since the output would carry no
    gradient: the straight-through backward is ``ops/quant.py:
    Int8MatmulSTE``, whose forward calls this with grad off.
    ``launches`` counts the calls on the card, and ``route_launches`` each
    route's.
    """
    _cuda.refuse_grad("int8_matmul", x, bias)
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return int8_matmul_fused_plain(x, w_q, w_scale, bias, activation,
                                       out_dtype)
    _check(x, w_q, w_scale, bias, activation, out_dtype)
    K, N = x.shape[-1], w_q.shape[0]
    M = x.numel() // K
    route = int8_route(M, K)
    if route == "two_pass":
        x_q, x_scale = quantize_rows(x.reshape(M, K))
        out = int8_gemm(x_q, x_scale, w_q, w_scale, bias, activation,
                        out_dtype).reshape(*x.shape[:-1], N)
    else:
        out = torch.empty(*x.shape[:-1], N, dtype=out_dtype, device=x.device)
        with torch.cuda.device(x.device):
            _cuda.launch(
                "int8_matmul", "ivlm_int8_matmul", _ARGTYPES,
                _cuda.ptr(x), int(x.dtype == torch.float32), _cuda.ptr(w_q),
                _cuda.ptr(w_scale),
                _cuda.ptr(bias) if bias is not None else ctypes.c_void_p(None),
                _cuda.ptr(out), int(out_dtype == torch.float32),
                ACTIVATIONS[activation], M, N, K, one_launch_plan(K)[0],
                _cuda.stream_handle(x.device),
            )
    int8_matmul_fused.launches += 1
    int8_matmul_fused.route_launches[route] += 1
    return out


int8_matmul_fused.launches = 0
int8_matmul_fused.route_launches = {"one_launch": 0, "two_pass": 0}


def quantize_rows_plain(x):
    """Plain version of the row quantize kernel: x (M, K) -> (x_q int8
    (M, K), x_scale f32 (M, 1)), with the fused kernel's quantization of x
    (the absmax in x's own type, x * (127 / amax) rounded half to even)."""
    amax = x.abs().amax(dim=-1, keepdim=True).float().clamp_min(SCALE_FLOOR)
    inv = exact_div(127.0, amax)
    q = torch.clamp(torch.round(x.float() * inv), -127, 127)
    return q.to(torch.int8), exact_div(amax, 127.0)


_QUANT_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def quantize_rows(x):
    """Per-row symmetric int8 quantization of (M, K) activations: returns
    (x_q int8 (M, K), x_scale f32 (M, 1)), as ``quantize_rows_plain``.

    CPU tensors run the plain version; CUDA tensors launch the kernel (x bf16
    or f32, contiguous, K a multiple of 8) or raise. Forward only."""
    _cuda.refuse_grad("quantize_rows", x)
    if not x.is_cuda:
        return quantize_rows_plain(x)
    if x.dim() != 2 or x.dtype not in X_DTYPES or x.shape[1] % 8:
        raise ValueError(f"quantize_rows: x must be bf16 or f32 (M, K) with K "
                         f"a multiple of 8, got {x.dtype} {tuple(x.shape)}")
    _cuda.require_kernel_inputs("quantize_rows", x, dtype=x.dtype)
    M, K = x.shape
    xq = torch.empty(M, K, dtype=torch.int8, device=x.device)
    xs = torch.empty(M, 1, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _cuda.launch(
            "int8_prequant", "ivlm_quantize_rows", _QUANT_ARGTYPES,
            _cuda.ptr(x), int(x.dtype == torch.float32), _cuda.ptr(xq),
            _cuda.ptr(xs), M, K, _cuda.stream_handle(x.device),
        )
    quantize_rows.launches += 1
    return xq, xs


quantize_rows.launches = 0


def quantize_rows_given_plain(x, amax):
    """Plain version of the given-scale row quantize: ``quantize_rows_plain``
    with each row's absmax ``amax`` (M,) given instead of taken from x."""
    a = amax.reshape(-1, 1).float().clamp_min(SCALE_FLOOR)
    inv = exact_div(127.0, a)
    q = torch.clamp(torch.round(x.float() * inv), -127, 127)
    return q.to(torch.int8), exact_div(a, 127.0)


_GIVEN_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def quantize_rows_given(x, amax):
    """Per-row int8 quantization of (M, K) activations with each row's
    absmax given, (M,) f32 (the row's max |x| over a length of which x is a
    slice): returns (x_q int8 (M, K), x_scale f32 (M, 1)), as
    ``quantize_rows_given_plain``. Kernel 7's given-scale route.

    CPU tensors run the plain version; CUDA tensors launch the kernel (x
    bf16 or f32, contiguous, K a multiple of 8; amax f32 contiguous) or
    raise. ``launches`` counts the launches. Forward only."""
    _cuda.refuse_grad("quantize_rows_given", x)
    if not x.is_cuda:
        return quantize_rows_given_plain(x, amax)
    if x.dim() != 2 or x.dtype not in X_DTYPES or x.shape[1] % 8:
        raise ValueError(f"quantize_rows_given: x must be bf16 or f32 (M, K) "
                         f"with K a multiple of 8, got {x.dtype} "
                         f"{tuple(x.shape)}")
    M, K = x.shape
    if amax.numel() != M:
        raise ValueError(f"quantize_rows_given: amax must hold {M} rows, got "
                         f"{tuple(amax.shape)}")
    _cuda.require_kernel_inputs("quantize_rows_given", x, dtype=x.dtype)
    _cuda.require_kernel_inputs("quantize_rows_given", amax,
                                dtype=torch.float32)
    xq = torch.empty(M, K, dtype=torch.int8, device=x.device)
    xs = torch.empty(M, 1, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _cuda.launch(
            "int8_prequant", "ivlm_quantize_rows_given", _GIVEN_ARGTYPES,
            _cuda.ptr(x), int(x.dtype == torch.float32), _cuda.ptr(amax),
            _cuda.ptr(xq), _cuda.ptr(xs), M, K,
            _cuda.stream_handle(x.device),
        )
    quantize_rows_given.launches += 1
    return xq, xs


quantize_rows_given.launches = 0


def int8_matmul_prequant_plain(x_q, x_scale, w_q, w_scale,
                               dtype=torch.bfloat16, activation: str = "none",
                               bias=None):
    """Plain version of the pre-quantized matmul kernel and of the int8
    GEMM: the int32 sum taken exactly, then (f32(acc) * x_scale) * w_scale,
    + bias (the GEMM's only), and the activation in f32, cast to
    ``dtype``."""
    out = (int_matmul_exact(x_q, w_q) * x_scale.reshape(-1, 1).float()
           * w_scale.float())
    if bias is not None:
        out = out + bias.float()
    return apply_activation(out, activation).to(dtype)


_GEMM_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                  + [ctypes.c_void_p])


def _launch_gemm(kernel, x_q, x_scale, w_q, w_scale, bias, activation, dtype):
    """Check what the wgmma int8 GEMM takes, raise on anything else, launch
    it (``bias`` None passes a null pointer) and return the output."""
    M, K = x_q.shape
    N = w_q.shape[0]
    if w_q.dim() != 2 or w_q.shape[1] != K or K % 32 or N % 8:
        raise ValueError(f"{kernel}: weight (N, {K}) with K a multiple of "
                         f"32 and N of 8, got {tuple(w_q.shape)}")
    f32 = [x_scale, w_scale] + ([bias] if bias is not None else [])
    if (x_scale.numel() != M or w_scale.shape != (N,)
            or (bias is not None and bias.shape != (N,))):
        raise ValueError(f"{kernel}: scales ({M}, 1) and ({N},), bias "
                         f"({N},), got {[tuple(t.shape) for t in f32]}")
    if dtype not in X_DTYPES or activation not in ACTIVATIONS:
        raise ValueError(f"{kernel}: output {dtype}, activation "
                         f"{activation!r}")
    _cuda.require_kernel_inputs(kernel, x_q, w_q, dtype=torch.int8)
    _cuda.require_kernel_inputs(kernel, *f32, dtype=torch.float32)
    if len({t.device for t in [x_q, w_q] + f32}) != 1:
        raise ValueError(f"{kernel}: all inputs must be on one CUDA device")
    out = torch.empty(M, N, dtype=dtype, device=x_q.device)
    with torch.cuda.device(x_q.device):
        _cuda.launch(
            "int8_gemm_sm90", "ivlm_int8_gemm", _GEMM_ARGTYPES,
            _cuda.ptr(x_q), _cuda.ptr(x_scale), _cuda.ptr(w_q),
            _cuda.ptr(w_scale),
            _cuda.ptr(bias) if bias is not None else ctypes.c_void_p(None),
            _cuda.ptr(out), int(dtype == torch.float32),
            ACTIVATIONS[activation], M, N, K,
            _cuda.stream_handle(x_q.device),
        )
    return out


def int8_matmul_prequant(x_q, x_scale, w_q, w_scale, dtype=torch.bfloat16,
                         activation: str = "none"):
    """Pre-quantized int8 x_q (M, K) with per-row scales (M, 1) @ int8 W
    (N, K) with per-column scales (N,) -> (M, N) in ``dtype``, with the
    rescale and the activation fused (no bias).

    CPU tensors run ``int8_matmul_prequant_plain``; CUDA tensors launch the
    wgmma int8 GEMM with no bias, as ``int8_gemm(..., bias=None)`` does
    (contiguous int8 x_q and W, f32 scales, K a multiple of 32, N of 8,
    ``dtype`` bf16 or f32), or raise. ``launches`` counts this wrapper's
    launches alone. Forward only."""
    _cuda.refuse_grad("int8_matmul_prequant", x_scale, w_scale)
    if not x_q.is_cuda:
        return int8_matmul_prequant_plain(x_q, x_scale, w_q, w_scale, dtype,
                                          activation)
    out = _launch_gemm("int8_matmul_prequant", x_q, x_scale, w_q, w_scale,
                       None, activation, dtype)
    int8_matmul_prequant.launches += 1
    return out


int8_matmul_prequant.launches = 0


def int8_gemm(x_q, x_scale, w_q, w_scale, bias=None, activation: str = "none",
              dtype=torch.bfloat16):
    """Pre-quantized int8 x_q (M, K) with per-row scales (M, 1) @ int8 W
    (N, K) with per-column scales (N,), + an optional f32 bias (N,), ->
    (M, N) in ``dtype``: pass 2 of ``int8_matmul_fused``'s two-pass route.

    CPU tensors run ``int8_matmul_prequant_plain``; CUDA tensors launch the
    wgmma kernel (contiguous int8 x_q and W, f32 scales and bias, K a
    multiple of 32, N of 8, ``dtype`` bf16 or f32) or raise. Forward
    only."""
    _cuda.refuse_grad("int8_gemm", x_scale, w_scale, bias)
    if not x_q.is_cuda:
        return int8_matmul_prequant_plain(x_q, x_scale, w_q, w_scale, dtype,
                                          activation, bias)
    out = _launch_gemm("int8_gemm", x_q, x_scale, w_q, w_scale, bias,
                       activation, dtype)
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0
