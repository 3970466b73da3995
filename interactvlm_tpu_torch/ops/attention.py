"""Attention dispatch: the hand-written flash kernel on CUDA, the plain
version elsewhere.

Mirrors ``interactvlm_tpu/ops/attention.py``: a bias-free attention with at
least 512 query rows goes to the flash kernel on the accelerator; everything
else, and every CPU tensor, runs the plain matmul-softmax attention
(``attention_plain``, the port of ``_xla_attention``).
"""

from __future__ import annotations

import torch

from interactvlm_tpu_torch.ops.flash_attention import (
    VIEW_HEAD_DIM,
    flash_attention,
)

FLASH_MIN_QUERIES = 512


def attention_plain(q, k, v, bias=None, causal=False, scale=None):
    """(B, H, Lq, D), (B, H, Lk, D) -> (B, H, Lq, D).

    Logits in f32 (products of the input dtype are exact in f32), an
    optional additive bias, causal masking aligned bottom-right (key c is
    visible to query r iff c - (Lk - Lq) <= r) with the f32 minimum as fill,
    softmax in f32, probabilities cast to the value dtype for P V.
    """
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        lq, lk = logits.shape[-2], logits.shape[-1]
        qi = torch.arange(lq, device=q.device)[:, None]
        ki = torch.arange(lk, device=q.device)[None, :]
        logits = logits.masked_fill(
            (ki - (lk - lq)) > qi, torch.finfo(torch.float32).min
        )
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v).to(v.dtype)


def dot_product_attention(q, k, v, bias=None, causal: bool = False,
                          scale: float | None = None):
    """Multi-head attention over (B, H, L, D) tensors.

    On a CUDA device, bias-free attention with Lq >= 512 launches the flash
    kernel (which raises on inputs it does not take); all other calls use
    ``attention_plain``. At head dim 16 the kernel reads the callers' head
    views in place and returns o as a view whose transpose back to tokens
    is contiguous; other head dims take contiguous copies.
    """
    if q.is_cuda and bias is None and q.shape[-2] >= FLASH_MIN_QUERIES:
        if q.shape[-1] == VIEW_HEAD_DIM:
            return flash_attention(q, k, v, causal=causal, scale=scale)
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, scale=scale)
    return attention_plain(q, k, v, bias=bias, causal=causal, scale=scale)
