"""SAM prompt encoder with the InteractVLM ``text_embeds`` path.

Port of ``interactvlm_tpu/models/sam/prompt_encoder.py``: projected [SEG]
embeddings as sparse prompts (the InteractVLM extension), point and box
prompts (random-Fourier encodings of their pixel coordinates plus a learned
embedding per label or corner), and as the dense prompt either a low-res
mask through ``mask_downscaling`` or the ``no_mask`` embedding broadcast
over the embedding grid. The sparse parts keep the JAX order: points, boxes,
text. Masks are channels-last (B, 4g, 4g, 1), as in the JAX package; the
convolutions permute to channels-first around the call.
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

    def _embed_points(self, points, labels, pad: bool):
        """points (B, N, 2) pixel (x, y), labels (B, N): 1 foreground, 0
        background, -1 not a point. Without boxes a padding point labelled
        -1 is appended (reference prompt_encoder.py:76-84)."""
        points = points.float() + 0.5
        if pad:
            points = torch.cat([points, torch.zeros_like(points[:, :1])], 1)
            labels = torch.cat([labels, -torch.ones_like(labels[:, :1])], 1)
        pe = self.pe_layer(points / float(self.config.img_size))
        lab = labels[..., None]
        emb = [e.weight[0].float() for e in self.point_embeddings]
        return torch.where(lab == -1, self.not_a_point_embed.weight[0].float(),
                           pe + torch.where(lab == 1, emb[1], emb[0]))

    def _embed_boxes(self, boxes):
        """boxes (B, 4) pixel (x0, y0, x1, y1) -> two corner tokens
        (B, 2, C)."""
        corner = self.pe_layer((boxes.float() + 0.5).reshape(-1, 2, 2)
                               / float(self.config.img_size))
        return torch.stack(
            [corner[:, 0] + self.point_embeddings[2].weight[0].float(),
             corner[:, 1] + self.point_embeddings[3].weight[0].float()], 1)

    def _embed_masks(self, masks):
        """(B, 4g, 4g, 1) -> (B, g, g, C)."""
        conv0, ln0, act0, conv1, ln1, act1, conv2 = self.mask_downscaling

        def conv(layer, x):  # channels-last around an NCHW convolution
            return layer(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

        x = act0(ln0(conv(conv0, masks.to(conv0.weight.dtype))))
        x = act1(ln1(conv(conv1, x)))
        return conv(conv2, x)

    def forward(self, text_embeds=None, points=None, point_labels=None,
                boxes=None, masks=None):
        """Returns (sparse (B, N, C), dense (B, g, g, C))."""
        cfg = self.config
        parts = []
        if points is not None:
            parts.append(self._embed_points(points, point_labels,
                                            pad=boxes is None))
        if boxes is not None:
            parts.append(self._embed_boxes(boxes))
        if text_embeds is not None:
            parts.append(text_embeds)
        if not parts:
            raise ValueError("at least one prompt type required")
        sparse = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        if masks is not None:
            return sparse, self._embed_masks(masks)
        g = cfg.image_embedding_size
        dense = self.no_mask_embed.weight[0].expand(
            sparse.shape[0], g, g, cfg.prompt_embed_dim)
        return sparse, dense
