"""CLIP vision tower in PyTorch.

Port of ``interactvlm_tpu/models/clip_vit.py`` (the frozen
``openai/clip-vit-large-patch14`` tower): pre-LN ViT with a class token,
quick-GELU MLPs, LayerNorm eps 1e-5, and the penultimate layer's patch tokens
(``select_layer=-2``). Names follow HF ``CLIPVisionModel``
(``vision_model.encoder.layers.{i}.self_attn.q_proj.weight`` ...).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from interactvlm_tpu_torch.config import CLIPVisionConfig
from interactvlm_tpu_torch.models.layers import LayerNorm, Linear
from interactvlm_tpu_torch.ops.attention import dot_product_attention
from interactvlm_tpu_torch.utils.device import resolve_device

LN_EPS = 1e-5


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device):
        super().__init__()
        self.heads = cfg.num_heads
        kw = dict(dtype=cfg.dtype, device=device)
        h = cfg.hidden_size
        self.q_proj = Linear(h, h, **kw)
        self.k_proj = Linear(h, h, **kw)
        self.v_proj = Linear(h, h, **kw)
        self.out_proj = Linear(h, h, **kw)

    def forward(self, x):
        B, L, C = x.shape

        def split(t):
            return t.view(B, L, self.heads, C // self.heads).transpose(1, 2)

        out = dot_product_attention(split(self.q_proj(x)),
                                    split(self.k_proj(x)),
                                    split(self.v_proj(x)))
        return self.out_proj(out.transpose(1, 2).reshape(B, L, C))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        self.fc1 = Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.fc2 = Linear(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device):
        super().__init__()
        kw = dict(eps=LN_EPS, dtype=cfg.dtype, device=device)
        self.self_attn = CLIPAttention(cfg, device)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, **kw)
        self.mlp = CLIPMLP(cfg, device)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, **kw)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False,
                                         **kw)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size, **kw))
        self.position_embedding = nn.Embedding(1 + cfg.num_patches,
                                               cfg.hidden_size, **kw)

    def forward(self, pixels):
        """(B, S, S, 3) channels-last pixels -> (B, 1 + P, hidden)."""
        w = self.patch_embedding.weight
        x = self.patch_embedding(pixels.permute(0, 3, 1, 2).to(w.dtype))
        x = x.flatten(2).transpose(1, 2)  # (B, P, C), patches row-major
        cls = self.class_embedding[None, None].expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.weight[None]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg, device)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, eps=LN_EPS,
                                      dtype=cfg.dtype, device=device)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            CLIPEncoderLayer(cfg, device) for _ in range(cfg.num_layers))


class CLIPVisionTower(nn.Module):
    """(B, S, S, 3) CLIP-normalized pixels -> the selected layer's patch
    tokens (B, num_patches, hidden), the features LLaVA's projector reads."""

    def __init__(self, config: CLIPVisionConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.vision_model = CLIPVisionTransformer(config, device)

    def forward(self, pixels):
        cfg = self.config
        vm = self.vision_model
        x = vm.pre_layrnorm(vm.embeddings(pixels))
        n_run = (cfg.num_layers + cfg.select_layer + 1
                 if cfg.select_layer < 0 else cfg.select_layer)
        selected = x
        for i, layer in enumerate(vm.encoder.layers):
            if i >= n_run:  # later layers never reach the output
                break
            x = layer(x)
            selected = x
        return selected[:, 1:]
