"""SAM ViT image encoder in PyTorch, channels-last.

Port of ``interactvlm_tpu/models/sam/image_encoder.py``: windowed attention
with the decomposed relative-position bias, global blocks, and the conv neck
to the 256-channel embedding. Tensors stay (B, H, W, C); the convolutions
permute to channels-first around the call. Names follow the SAM checkpoint
(``blocks.{i}.attn.qkv.weight``, ``neck.0.weight`` ...). The global blocks
(H*W >= 1024) go to the global rel-pos attention and every other block to
the window attention, as the JAX package routes them on the TPU
(``image_encoder.py:160-197``): on CUDA each launches its kernel, on the CPU
its plain version. Under ``SAMConfig.weights_int8`` the qkv, proj, lin1
and lin2 linears are ``Int8Linear`` with a separate f32 bias, and lin1
carries the GELU (tanh under ``gelu_approx``) in the int8 kernel's epilogue
(``image_encoder.py:23-64``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from interactvlm_tpu_torch.config import SAMConfig
from interactvlm_tpu_torch.models.layers import Int8Linear, LayerNorm, Linear
from interactvlm_tpu_torch.ops.sam_attention import (
    fused_rel_attention,
    fused_window_attention,
    rel_tables,
)
from interactvlm_tpu_torch.utils.device import resolve_device

LN_EPS = 1e-6
GLOBAL_KERNEL_MIN_TOKENS = 1024


def window_partition(x, window_size: int):
    """(B, H, W, C) -> ((B * nW, ws, ws, C), (Hp, Wp)), zero-padding the
    bottom/right (64 -> 70 for ViT-H: 25 windows of 14 x 14)."""
    B, H, W, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - W % window_size) % window_size
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // window_size, window_size, Wp // window_size,
                  window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size,
                                                  window_size, C)
    return windows, (Hp, Wp)


def window_unpartition(windows, window_size: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // window_size // window_size)
    x = windows.reshape(B, Hp // window_size, Wp // window_size, window_size,
                        window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


def decomposed_rel_pos_bias(q, rel_pos_h, rel_pos_w, hw):
    """q (B, nH, H*W, d) -> bias (B, nH, H*W, H*W) in q's dtype (reference
    ``add_decomposed_rel_pos``)."""
    H, W = hw
    B, nH = q.shape[:2]
    r_q = q.reshape(B, nH, H, W, -1)
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, rel_tables(rel_pos_h, H))
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, rel_tables(rel_pos_w, W))
    bias = rel_h[..., :, None] + rel_w[..., None, :]
    return bias.reshape(B, nH, H * W, H * W)


def encoder_linear(in_features: int, out_features: int, int8: bool, dtype,
                   device, activation: str = "none"):
    """An encoder linear with bias: ``Int8Linear`` (f32 bias, fused
    ``activation``) in the int8 mode, else ``Linear``, whose caller applies
    any activation itself."""
    if int8:
        return Int8Linear(in_features, out_features, bias=True,
                          activation=activation, dtype=dtype, device=device)
    return Linear(in_features, out_features, dtype=dtype, device=device)


class Attention(nn.Module):
    """Multi-head attention with decomposed relative position bias."""

    def __init__(self, dim: int, num_heads: int, input_size: Tuple[int, int],
                 dtype, device, int8: bool = False):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        kw = dict(dtype=dtype, device=device)
        self.qkv = encoder_linear(dim, dim * 3, int8, dtype, device)
        self.proj = encoder_linear(dim, dim, int8, dtype, device)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1,
                                                  head_dim, **kw))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1,
                                                  head_dim, **kw))

    def forward(self, x):
        B, H, W, C = x.shape
        hd = C // self.num_heads
        qkv = self.qkv(x).reshape(B, H * W, 3, self.num_heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (B, nH, HW, hd)
        rh = self.rel_pos_h.to(q.dtype)
        rw = self.rel_pos_w.to(q.dtype)
        if H * W >= GLOBAL_KERNEL_MIN_TOKENS:
            out = fused_rel_attention(q, k, v, rh, rw, (H, W))
        else:
            out = fused_window_attention(q, k, v, rh, rw, (H, W))
        return self.proj(out.transpose(1, 2).reshape(B, H, W, C))


class MLPBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, gelu_approx: bool, dtype,
                 device, int8: bool = False):
        super().__init__()
        # int8: the GELU rides lin1's kernel epilogue
        self.act = None if int8 else ("tanh" if gelu_approx else "none")
        self.lin1 = encoder_linear(
            dim, mlp_dim, int8, dtype, device,
            activation="gelu_tanh" if gelu_approx else "gelu")
        self.lin2 = encoder_linear(mlp_dim, dim, int8, dtype, device)

    def forward(self, x):
        h = self.lin1(x)
        if self.act is not None:
            h = F.gelu(h, approximate=self.act)
        return self.lin2(h)


class Block(nn.Module):
    def __init__(self, cfg: SAMConfig, window_size: int, device):
        super().__init__()
        dim = cfg.encoder_embed_dim
        grid = cfg.image_embedding_size
        self.window_size = window_size  # 0 = global
        size = (window_size, window_size) if window_size > 0 else (grid, grid)
        kw = dict(dtype=cfg.dtype, device=device)
        self.norm1 = LayerNorm(dim, eps=LN_EPS, **kw)
        self.attn = Attention(dim, cfg.encoder_num_heads, size, cfg.dtype,
                              device, cfg.weights_int8)
        self.norm2 = LayerNorm(dim, eps=LN_EPS, **kw)
        self.mlp = MLPBlock(dim, int(dim * cfg.mlp_ratio), cfg.gelu_approx,
                            cfg.dtype, device, cfg.weights_int8)

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            H, W = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, (H, W))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SAMConfig, device):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.encoder_embed_dim, cfg.patch_size,
                              stride=cfg.patch_size, dtype=cfg.dtype,
                              device=device)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.proj.weight.dtype)
        return self.proj(x).permute(0, 2, 3, 1)


def _conv_nhwc(conv: nn.Conv2d, x):
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    """(B, S, S, 3) normalized pixels -> (B, S/16, S/16, prompt_embed_dim)."""

    def __init__(self, config: SAMConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        cfg = config
        g = cfg.image_embedding_size
        kw = dict(dtype=cfg.dtype, device=device)
        self.patch_embed = PatchEmbed(cfg, device)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g,
                                                  cfg.encoder_embed_dim, **kw))
        self.blocks = nn.ModuleList(
            Block(cfg, 0 if i in cfg.encoder_global_attn_indexes
                  else cfg.window_size, device)
            for i in range(cfg.encoder_depth))
        d = cfg.prompt_embed_dim
        self.neck = nn.ModuleList([
            nn.Conv2d(cfg.encoder_embed_dim, d, 1, bias=False, **kw),
            LayerNorm(d, eps=LN_EPS, **kw),
            nn.Conv2d(d, d, 3, padding=1, bias=False, **kw),
            LayerNorm(d, eps=LN_EPS, **kw),
        ])

    def forward(self, x):
        x = self.patch_embed(x) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        x = self.neck[1](_conv_nhwc(self.neck[0], x))
        return self.neck[3](_conv_nhwc(self.neck[2], x))
