"""Int8 and int4 quantization: weights, activations and the KV cache.

Port of ``interactvlm_tpu/ops/quant.py``: symmetric per-slice int8 with f32
scales, rounding half to even; the int8 matmul with its straight-through
backward (QLoRA training over a frozen int8 base); packed split-half int4
weights with rank-1 group scales (serving only). Weights are in the port's
(N, K) layout, K-contiguous per output column, with one f32 scale per
output column, (N,); the JAX package keeps (K, N) and (1, N). A packed int4
weight is (N, K/2) int8: byte j of a row holds w[j] in its low nibble and
w[j + K/2] in its high one (the JAX (K/2, N) layout, transposed).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from interactvlm_tpu_torch.ops import _cuda

SCALE_FLOOR = 1e-8


def exact_div(num, den):
    """num / den rounded once, as IEEE division is, on every device; either
    side may be a Python float. torch rounds twice where one side is a
    Python number: ``x / 127.0`` runs as x * (1 / 127) on CUDA, and
    ``127.0 / x`` as reciprocal(x) * 127 everywhere. Both sides as tensors
    take the true division."""
    ref = num if torch.is_tensor(num) else den
    if not torch.is_tensor(num):
        num = ref.new_full((), num)
    if not torch.is_tensor(den):
        den = ref.new_full((), den)
    return num / den


def quantize_int8(x, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-slice int8 quantization along ``axis``: scale =
    max(amax, 1e-8) / 127, q = clip(round(x / scale), -127, 127) with
    ``torch.round``'s half-to-even rule. Returns (q int8, scale f32 with
    ``axis`` kept as size 1)."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = exact_div(amax.clamp_min(SCALE_FLOOR), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def int_matmul_exact(a_q, w_q):
    """(..., K) int8 @ (N, K) int8 -> (..., N) f32, the int32 sum exactly:
    products and partial sums of int8 values are exact in float64 for any K
    here (|sum| <= 127^2 K < 2^53), and float64 -> f32 rounds the exact sum
    as int32 -> f32 does."""
    return torch.matmul(a_q.double(), w_q.double().t()).float()


def int8_matmul(x, w_q, w_scale, dtype=torch.bfloat16):
    """x (..., K) @ int8 W (N, K) with per-output-column scales (N,): the
    JAX package's composition (quantize x per row, int8 x int8 -> int32,
    rescale by both scales), the path it takes on the CPU. Forward only;
    ``int8_matmul_ste`` is the differentiable form."""
    x_q, x_scale = quantize_int8(x, axis=-1)
    return (int_matmul_exact(x_q, w_q) * x_scale * w_scale).to(dtype)


def _int8_forward(x, w_q, w_scale, dtype):
    """The forward of ``int8_matmul_ste``: on a CUDA tensor kernel 6
    (``ops/int8_matmul.py:int8_matmul_fused``, on the route its row count
    picks), on a CPU tensor the composition ``int8_matmul``."""
    if not x.is_cuda:
        return int8_matmul(x, w_q, w_scale, dtype)
    return _kernel6(x, w_q, w_scale, dtype)


def _kernel6(x, w_q, w_scale, dtype):
    """``int8_matmul_fused`` on the rows of x (..., K), no bias."""
    # imported here: ops/int8_matmul.py imports this module
    from interactvlm_tpu_torch.ops.int8_matmul import int8_matmul_fused

    K, N = x.shape[-1], w_q.shape[0]
    return int8_matmul_fused(x.reshape(-1, K), w_q, w_scale,
                             out_dtype=dtype).reshape(*x.shape[:-1], N)


def ste_input_grad(g, w_q, w_scale, dtype):
    """The straight-through activation gradient of x @ dequant(W): dx =
    ((g * w_scale) rounded to bf16) @ W_q, the bf16 products summed in f32,
    the f32 result cast to ``dtype`` (``interactvlm_tpu/ops/quant.py:
    _int8_matmul_bwd``). The scale is folded into g, so no dequantized
    weight is made; W_q is widened to a transient bf16 copy (exact: |q| <=
    127). On the card one bf16 GEMM with an f32 output (``torch.mm``'s
    ``out_dtype``), which the JAX package also leaves to the compiler's
    dot; on the CPU an f32 product of the bf16 values (each product exact,
    as in the JAX CPU dot)."""
    N, K = w_q.shape
    gs = (g.float() * w_scale).to(torch.bfloat16).reshape(-1, N)
    w = w_q.to(torch.bfloat16)
    if g.is_cuda:
        dx = torch.mm(gs, w, out_dtype=torch.float32)
    else:
        dx = torch.mm(gs.float(), w.float())
    return dx.reshape(*g.shape[:-1], K).to(dtype)


class Int8MatmulSTE(torch.autograd.Function):
    """x (..., K) @ int8 W (N, K) -> (..., N) in ``dtype``, differentiable
    in x by the straight-through estimator of the JAX package's
    ``_int8_matmul_core`` (``custom_vjp``, ``ops/quant.py:33-67``): the
    forward is ``_int8_forward``, the backward ``ste_input_grad``, and the
    int8 weight and its scales get no gradient (the base is frozen). Grad is
    off inside ``forward``, so kernel 6's wrappers, which refuse grad when
    called directly, run there. Saves W_q and its scales, not x."""

    @staticmethod
    def forward(ctx, x, w_q, w_scale, dtype):
        ctx.save_for_backward(w_q, w_scale)
        ctx.x_dtype = x.dtype
        return _int8_forward(x, w_q, w_scale, dtype)

    @staticmethod
    def backward(ctx, g):
        w_q, w_scale = ctx.saved_tensors
        return ste_input_grad(g, w_q, w_scale, ctx.x_dtype), None, None, None


def int8_matmul_ste(x, w_q, w_scale, dtype=torch.bfloat16):
    """``Int8MatmulSTE`` where x needs a gradient; otherwise its forward
    alone, without the autograd Function's cost on the host (decode issues
    225 of these a step)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return Int8MatmulSTE.apply(x, w_q, w_scale, dtype)
    return _int8_forward(x, w_q, w_scale, dtype)


# --- int4: packed split-half nibbles, rank-1 group scales -----------------
# W[n, k] ~= row_factor[k] * col_scale[n] * q[n, k], q in [-8, 7]: the row
# factor rides the activation before its int8 quantization, the column
# scale rescales the int32 sum (``interactvlm_tpu/ops/quant.py:124-149``).


def quantize_int4(w, group: int = 128):
    """Quantize an (N, K) weight to packed split-half int4: returns (q4 int8
    (N, K/2), col_scale f32 (N,), row_factor f32 (K,)). K must be even;
    where ``group`` divides K (and K >= 2 group) the row factor is the
    per-group mean over the columns of each group's absmax, else 1. The
    JAX package's ``quantize_int4`` on the transposed weight."""
    N, K = w.shape
    if K % 2:
        raise ValueError(f"int4 packing needs even K, got {K}")
    wf = w.float()
    if group > 0 and K % group == 0 and K >= 2 * group:
        amax_g = wf.abs().reshape(N, K // group, group).amax(-1)  # (N, G)
        r_g = amax_g.mean(0).clamp_min(SCALE_FLOOR)  # (G,)
        rf = r_g.repeat_interleave(group)
    else:
        rf = torch.ones(K, dtype=torch.float32, device=w.device)
    wn = wf / rf
    col_scale = exact_div(wn.abs().amax(1).clamp_min(SCALE_FLOOR), 7.0)
    q = torch.clamp(torch.round(wn / col_scale[:, None]), -8, 7)
    return pack_int4(q), col_scale, rf


def pack_int4(q):
    """Pack an (N, K) integer weight in [-8, 7] into split-half nibbles,
    (N, K/2) int8: byte j holds column j low and column j + K/2 high."""
    q = q.to(torch.int16)
    K = q.shape[1]
    return ((q[:, :K // 2] & 0x0F) | (q[:, K // 2:] << 4)).to(torch.int8)


def unpack_int4(packed):
    """Split a packed (N, K/2) int8 weight into its (lo, hi) int8 nibbles,
    sign-extended: lo holds columns [0, K/2), hi [K/2, K)."""
    lo = ((packed & 0x0F) ^ 8) - 8
    return lo, packed >> 4


def dequantize_int4(packed, col_scale, row_factor, dtype=torch.float32):
    """The dense (N, K) weight (tests and conversion checks only)."""
    q = torch.cat(unpack_int4(packed), dim=1).float()
    return (q * row_factor * col_scale[:, None]).to(dtype)


def int4_matmul(x, packed, col_scale, row_factor, dtype=torch.bfloat16):
    """x (..., K) @ packed-int4 W (N, K/2) -> (..., N) in ``dtype``: x times
    the row factor in f32, quantized per row to int8, an exact int32 sum
    over both halves of K, times the row scale and the column scale.

    On a CPU tensor the JAX package's composition (its two half-K int8
    products are one exact sum here). On a CUDA tensor kernel 6
    (``int8_matmul_fused``) on the f32 product x * rf and the unpacked
    (N, K) int8 weight, a transient copy each call; the kernel quantizes x
    with x * (127 / amax) where the composition divides by amax / 127 (a
    rounding tie apart). Serving only: raises under grad."""
    _cuda.refuse_grad("int4_matmul", x)
    xr = x.float() * row_factor
    w = torch.cat(unpack_int4(packed), dim=1)
    if x.is_cuda:
        return _kernel6(xr, w, col_scale, dtype)
    x_q, x_scale = quantize_int8(xr, axis=-1)
    return (int_matmul_exact(x_q, w) * x_scale * col_scale).to(dtype)


# --- row-parallel int8 and int4 (tensor parallelism over ``model``) -------
# A row-parallel linear holds the columns [r K / n, (r + 1) K / n) of its
# weight and takes that slice of each input row. The JAX composition,
# partitioned by XLA over the same layout, takes each row's absmax over the
# whole K (a MAX all-reduce of the slices'), so every element quantizes to
# the unsharded byte; the int32 partial sums, rescaled, add up over the
# model ranks.


def row_parallel_quantize(x, group, row_factor=None):
    """Quantize this rank's slice x (..., K/n) of each row with the whole
    row's scale: the slices' absmax all-reduced (MAX) over ``group``, then
    the JAX package's ``quantize_int8`` rule (x / scale, half to even).
    With ``row_factor`` (the int4 weight's ``weight_rf`` slice) x * rf is
    quantized, as ``int4_matmul`` does. Returns (q int8, scale f32 (..., 1)),
    the unsharded row's bytes and scale."""
    from interactvlm_tpu_torch.parallel.collectives import all_reduce_max

    xf = x.float() if row_factor is None else x.float() * row_factor
    amax = all_reduce_max(xf.abs().amax(dim=-1, keepdim=True), group)
    scale = exact_div(amax.clamp_min(SCALE_FLOOR), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def _row_partial(x, w_q, w_scale, group, row_factor=None):
    """This rank's f32 partial of the row-parallel product: on a CPU tensor
    ``row_parallel_quantize`` and the exact int32 sum; on a CUDA tensor the
    slices' absmax all-reduced, kernel 7's given-scale route
    (``quantize_rows_given``) and the int8 GEMM to f32."""
    K, N = x.shape[-1], w_q.shape[0]
    if not x.is_cuda:
        q, scale = row_parallel_quantize(x, group, row_factor)
        return int_matmul_exact(q, w_q) * scale * w_scale
    from interactvlm_tpu_torch.ops.int8_matmul import (
        int8_gemm,
        quantize_rows_given,
    )
    from interactvlm_tpu_torch.parallel.collectives import all_reduce_max

    xr = x.reshape(-1, K)
    xr = xr.float() * row_factor if row_factor is not None else xr
    xr = xr.contiguous()
    amax = all_reduce_max(xr.abs().amax(dim=-1).float(), group)
    xq, xs = quantize_rows_given(xr, amax)
    out = int8_gemm(xq, xs, w_q, w_scale, dtype=torch.float32)
    return out.reshape(*x.shape[:-1], N)


class _RowParallelInt8(torch.autograd.Function):
    """The row-parallel int8 partial product, differentiable in x by the
    straight-through rule (``ste_input_grad`` on this rank's columns)."""

    @staticmethod
    def forward(ctx, x, w_q, w_scale, group):
        ctx.save_for_backward(w_q, w_scale)
        ctx.x_dtype = x.dtype
        return _row_partial(x, w_q, w_scale, group)

    @staticmethod
    def backward(ctx, g):
        w_q, w_scale = ctx.saved_tensors
        return ste_input_grad(g, w_q, w_scale, ctx.x_dtype), None, None, None


def int8_matmul_row_parallel(x, w_q, w_scale, group, dtype=torch.bfloat16):
    """x (..., K/n) @ this rank's int8 columns W (N, K/n), summed over the
    model ranks of ``group`` -> (..., N) in ``dtype`` on every rank: the
    unsharded ``int8_matmul`` up to the f32 order of the partial sums."""
    from interactvlm_tpu_torch.parallel.collectives import reduce_from

    if torch.is_grad_enabled() and x.requires_grad:
        part = _RowParallelInt8.apply(x, w_q, w_scale, group)
    else:
        part = _row_partial(x, w_q, w_scale, group)
    return reduce_from(part, group).to(dtype)


def int4_matmul_row_parallel(x, packed, col_scale, row_factor, group,
                             dtype=torch.bfloat16):
    """x (..., K/n) @ this rank's packed int4 columns (N, K/(2n)) (the
    rank's contiguous slice, packed split-half on its own,
    ``parallel/mesh.py:shard_tensor``) with its slice of the row factor,
    summed over ``group``: the unsharded ``int4_matmul``, whose x * rf
    quantizes with the whole row's absmax. Serving only."""
    from interactvlm_tpu_torch.parallel.collectives import reduce_from

    _cuda.refuse_grad("int4_matmul", x)
    w = torch.cat(unpack_int4(packed), dim=1)
    part = _row_partial(x, w, col_scale, group, row_factor)
    return reduce_from(part, group).to(dtype)


def init_kv_cache_int8(config, batch: int, max_len: int,
                       device, n_model: int = 1) -> List[Dict]:
    """Fresh per-layer int8 KV caches: k/v (B, L, nkv, d) int8, k_scale/
    v_scale (B, L, nkv, 1) f32, the key-validity row (B, L) int8 and the
    cursor. Under tensor parallelism over ``n_model`` ranks a rank caches
    its own nkv / n_model heads."""
    shape = (batch, max_len, config.num_kv_heads // n_model, config.head_dim)
    sshape = shape[:3] + (1,)
    return [
        {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
            "valid": torch.zeros(batch, max_len, dtype=torch.int8,
                                 device=device),
            "index": 0,
        }
        for _ in range(config.num_layers)
    ]


def append_kv_cache_int8(cache: Dict, k_new, v_new) -> Dict:
    """Quantize a (B, L, nkv, d) chunk per position and head and write it at
    the cache cursor, then advance the cursor by L.

    Unlike the JAX function, which returns a new cache, this writes the
    preallocated int8 tensors and scales in place (as the dense cache is
    written, ``models/llama.py``) and returns the same dict. The key-validity
    row is the caller's to write. K/V stay int8: the attention folds the
    scales into its logits and probabilities."""
    idx = cache["index"]
    L = k_new.shape[1]
    for name, new in (("k", k_new), ("v", v_new)):
        q, s = quantize_int8(new, axis=-1)
        cache[name][:, idx:idx + L] = q
        cache[name + "_scale"][:, idx:idx + L] = s
    cache["index"] = idx + L
    return cache
