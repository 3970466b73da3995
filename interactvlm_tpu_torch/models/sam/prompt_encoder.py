"""SAM prompt encoder with the InteractVLM ``text_embeds`` path.

Port of ``interactvlm_tpu/models/sam/prompt_encoder.py`` for what the
generate-mode path runs: projected [SEG] embeddings as the sparse prompt,
the random-Fourier dense positional encoding, and the ``no_mask`` dense
embedding. The point, box and mask-downscaling parameters are kept so the
SAM checkpoint loads by key, but their prompt paths are not ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from interactvlm_tpu_torch.config import SAMConfig
from interactvlm_tpu_torch.models.layers import LayerNorm
from interactvlm_tpu_torch.utils.device import resolve_device


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier positional encoding (reference prompt_encoder.py:189-238)."""

    def __init__(self, num_pos_feats: int, dtype, device):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn(2, num_pos_feats, dtype=dtype,
                                         device=device))

    def forward(self, coords01):
        """coords01: (..., 2) in [0, 1]^2 -> (..., 2 * num_pos_feats) f32."""
        coords = 2.0 * coords01.float() - 1.0
        proj = (2.0 * math.pi) * (
            coords @ self.positional_encoding_gaussian_matrix.float())
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)

    def grid(self, h: int, w: int):
        """(h, w, C) dense positional encoding, channels-last."""
        dev = self.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        grid = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)],
                           dim=-1)
        return self(grid)


class PromptEncoder(nn.Module):
    def __init__(self, config: SAMConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        dim = config.prompt_embed_dim
        kw = dict(dtype=config.dtype, device=device)
        self.pe_layer = PositionEmbeddingRandom(dim // 2, config.dtype, device)
        self.point_embeddings = nn.ModuleList(
            nn.Embedding(1, dim, **kw) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, dim, **kw)
        self.no_mask_embed = nn.Embedding(1, dim, **kw)
        ch = config.mask_in_chans
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, ch // 4, 2, stride=2, **kw),
            LayerNorm(ch // 4, eps=1e-6, **kw),
            nn.GELU(),
            nn.Conv2d(ch // 4, ch, 2, stride=2, **kw),
            LayerNorm(ch, eps=1e-6, **kw),
            nn.GELU(),
            nn.Conv2d(ch, dim, 1, **kw),
        )

    def get_dense_pe(self):
        g = self.config.image_embedding_size
        return self.pe_layer.grid(g, g)  # (g, g, C)

    def forward(self, text_embeds):
        """Returns (sparse (B, N, C), dense (B, g, g, C))."""
        cfg = self.config
        g = cfg.image_embedding_size
        dense = self.no_mask_embed.weight[0].expand(
            text_embeds.shape[0], g, g, cfg.prompt_embed_dim)
        return text_embeds, dense
