"""Flash attention: the forward kernel ``csrc/flash_attention.cu``, the two
backward kernels ``csrc/flash_attention_bwd.cu``, their plain PyTorch
versions, and the autograd Function that joins them.

Ports of ``interactvlm_tpu/ops/flash_attention.py``: ``_flash_kernel`` (the
Pallas TPU kernel, wrapper ``_flash_forward``), ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` (wrapper ``_flash_backward``), and the ``custom_vjp``
that wires them (``FlashAttention`` here). The kernel sources say what
bounds each on the H100 and how its design answers that.

Semantics, for q (B, H, Lq, D) and k, v (B, H, Lk, D): scale defaults to
D^-1/2; key c is visible to query r iff c < kv_lengths[b] (when given) and,
under ``causal``, c <= r + (Lk - Lq); the output is the softmax-weighted sum
of the visible values, and the per-row logsumexp is returned as
(B*H, Lq) f32. A row that sees no key gives 0 and logsumexp 0. (The Pallas
kernel's masked logits are -1e30 rather than -inf, so for such a row it
returns the mean of its block-padded values instead; no caller reaches a
fully masked row.)
"""

from __future__ import annotations

import ctypes

import torch

from interactvlm_tpu_torch.ops import _cuda

KERNEL_HEAD_DIMS = (16, 32, 64, 128)


def _visible(B, Lq, Lk, causal, kv_lengths, device):
    kidx = torch.arange(Lk, device=device)
    vis = torch.ones(B, 1, Lq, Lk, dtype=torch.bool, device=device)
    if kv_lengths is not None:
        vis = vis & (kidx[None, None, None, :]
                     < kv_lengths.to(device)[:, None, None, None])
    if causal:
        qidx = torch.arange(Lq, device=device)
        vis = vis & (kidx[None, :] <= qidx[:, None] + (Lk - Lq))
    return vis


def flash_forward_plain(q, k, v, causal=False, scale=None, kv_lengths=None):
    """Plain version of the kernel: returns (o (B, H, Lq, D), lse (B*H, Lq))."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s.masked_fill(~_visible(B, Lq, Lk, causal, kv_lengths, q.device),
                      float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    seen = l > 0
    o = torch.where(seen, acc / torch.where(seen, l, torch.ones_like(l)), 0.0)
    lse = torch.where(seen, m + torch.log(torch.where(seen, l, 1.0)), 0.0)
    return o.to(v.dtype), lse.reshape(B * H, Lq)


_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def flash_forward(q, k, v, causal=False, scale=None, kv_lengths=None):
    """Flash attention forward over (B, H, L, D): returns (o, lse).

    CPU tensors run ``flash_forward_plain``; CUDA tensors launch the kernel
    (bf16, contiguous, head dim in ``KERNEL_HEAD_DIMS``) or raise.
    """
    if not q.is_cuda:
        return flash_forward_plain(q, k, v, causal, scale, kv_lengths)
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if k.shape != (B, H, Lk, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {q.shape} {k.shape} {v.shape}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {KERNEL_HEAD_DIMS}")
    _cuda.require_kernel_inputs("flash_attention", q, k, v)
    lens = None
    if kv_lengths is not None:
        lens = kv_lengths.to(device=q.device, dtype=torch.int32).contiguous()
        if lens.shape != (B,):
            raise ValueError(f"flash_attention: kv_lengths shape {lens.shape}")
    scale = D ** -0.5 if scale is None else scale
    o = torch.empty_like(q)
    lse = torch.empty(B * H, Lq, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _cuda.launch(
            "flash_attention", "ivlm_flash_fwd", _ARGTYPES,
            _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(o),
            _cuda.ptr(lse),
            _cuda.ptr(lens) if lens is not None else ctypes.c_void_p(None),
            B * H, H, Lq, Lk, D, float(scale), int(bool(causal)),
            _cuda.stream_handle(q.device),
        )
    flash_forward.launches += 1
    return o, lse


flash_forward.launches = 0


def flash_backward_plain(q, k, v, o, lse, do, causal=False, scale=None,
                         kv_lengths=None):
    """Plain version of the two backward kernels: the recompute formula of
    the JAX package's ``_flash_backward``. P = exp(S * scale - lse) on the
    visible keys (0 elsewhere), D = rowsum(dO * O) in f32,
    dS = P * (dP - D) with dP = dO V^T, all in f32; then dQ = scale * dS K,
    dK = scale * dS^T Q and dV = P^T dO with P and dS rounded to the
    inputs' dtype as the products' operands, as the kernels round them (the
    TPU dq kernel rounds dS so; its f32 dk/dv products run at the TPU's
    default one-pass bf16 precision). Accumulation in f32, or in f64 for
    f64 inputs. In f32 or f64 the rounding is none: f64 inputs give the
    exact value that the kernels approximate. Returns (dq, dk, dv) in the
    inputs' dtypes."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf, kf, dof = q.to(acc), k.to(acc), do.to(acc)
    dsum = (dof * o.to(acc)).sum(-1, keepdim=True)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    vis = _visible(B, Lq, Lk, causal, kv_lengths, q.device)
    p = torch.where(vis, torch.exp(s - lse.reshape(B, H, Lq, 1)), 0.0)
    ds = p * (torch.matmul(dof, v.to(acc).transpose(-1, -2)) - dsum)
    ds, p = ds.to(q.dtype).to(acc), p.to(q.dtype).to(acc)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_BWD_ARGTYPES = {
    n: [ctypes.c_void_p] * n + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    for n in (8, 9)
}


def _bwd_args(q, k, kv_lengths, causal, scale):
    B, H, Lq, D = q.shape
    return (_cuda.ptr(kv_lengths) if kv_lengths is not None
            else ctypes.c_void_p(None),
            B * H, H, Lq, k.shape[2], D, float(scale), int(bool(causal)),
            _cuda.stream_handle(q.device))


def flash_bwd_dq(q, k, v, do, lse, dsum, causal, scale, kv_lengths):
    """Launch the dq kernel (CUDA only; ``flash_backward`` checks the
    inputs). lse and dsum are (B*H, Lq) f32; kv_lengths int32 or None."""
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _cuda.launch(
            "flash_attention_bwd", "ivlm_flash_bwd_dq", _BWD_ARGTYPES[8],
            _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(do),
            _cuda.ptr(lse), _cuda.ptr(dsum), _cuda.ptr(dq),
            *_bwd_args(q, k, kv_lengths, causal, scale))
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, dsum, causal, scale, kv_lengths):
    """Launch the dk/dv kernel (CUDA only, as ``flash_bwd_dq``)."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _cuda.launch(
            "flash_attention_bwd", "ivlm_flash_bwd_dkv", _BWD_ARGTYPES[9],
            _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(do),
            _cuda.ptr(lse), _cuda.ptr(dsum), _cuda.ptr(dk), _cuda.ptr(dv),
            *_bwd_args(q, k, kv_lengths, causal, scale))
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_backward(q, k, v, o, lse, do, causal=False, scale=None,
                   kv_lengths=None):
    """Flash attention backward: (dq, dk, dv) from the forward's inputs, its
    output o and logsumexp lse (B*H, Lq), and the output gradient do.

    CPU tensors run ``flash_backward_plain``; CUDA tensors launch the dq and
    the dk/dv kernels (bf16, contiguous, head dim in ``KERNEL_HEAD_DIMS``)
    or raise. D = rowsum(dO * O) is taken in torch, in f32, outside the
    kernels, as the JAX package takes it.
    """
    if not q.is_cuda:
        return flash_backward_plain(q, k, v, o, lse, do, causal, scale,
                                    kv_lengths)
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if (k.shape != (B, H, Lk, D) or v.shape != k.shape or o.shape != q.shape
            or do.shape != q.shape):
        raise ValueError(f"flash_backward: shapes q {q.shape} k {k.shape} "
                         f"v {v.shape} o {o.shape} do {do.shape}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_backward: head dim {D} not in "
                         f"{KERNEL_HEAD_DIMS}")
    _cuda.require_kernel_inputs("flash_backward", q, k, v, o, do)
    _cuda.require_kernel_inputs("flash_backward", lse, dtype=torch.float32)
    if lse.shape != (B * H, Lq) or lse.device != q.device:
        raise ValueError(f"flash_backward: lse {tuple(lse.shape)} on "
                         f"{lse.device}, expected ({B * H}, {Lq})")
    lens = None
    if kv_lengths is not None:
        lens = kv_lengths.to(device=q.device, dtype=torch.int32).contiguous()
        if lens.shape != (B,):
            raise ValueError(f"flash_backward: kv_lengths shape {lens.shape}")
    scale = D ** -0.5 if scale is None else scale
    dsum = (do.float() * o.float()).sum(-1).reshape(B * H, Lq)
    dq = flash_bwd_dq(q, k, v, do, lse, dsum, causal, scale, lens)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, dsum, causal, scale, lens)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the forward kernel, and on the
    backward the two backward kernels over the saved (q, k, v, o, lse)
    (the JAX package's ``custom_vjp``, ``flash_attention.py:402-421``).
    CPU tensors take the plain versions both ways."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kv_lengths):
        o, lse = flash_forward(q, k, v, causal, scale, kv_lengths)
        ctx.save_for_backward(q, k, v, o, lse, kv_lengths)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_lengths = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do.contiguous(),
                                    ctx.causal, ctx.scale, kv_lengths)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=False, scale=None, kv_lengths=None):
    """Flash attention over (B, H, L, D), the output only, differentiable
    in q, k and v through ``FlashAttention``."""
    return FlashAttention.apply(q, k, v, causal, scale, kv_lengths)
