"""Flash attention forward: the CUDA kernel ``csrc/flash_attention.cu`` and
its plain PyTorch version.

Port of ``interactvlm_tpu/ops/flash_attention.py:_flash_kernel`` (the Pallas
TPU kernel, wrapper ``_flash_forward``). The kernel source says what bounds
it on the H100 and how its design answers that.

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


def flash_attention(q, k, v, causal=False, scale=None, kv_lengths=None):
    """Flash attention over (B, H, L, D); the output only."""
    return flash_forward(q, k, v, causal, scale, kv_lengths)[0]
