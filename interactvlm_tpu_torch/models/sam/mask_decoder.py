"""SAM mask decoder in PyTorch: output tokens, two-way transformer and
hypernetwork mask heads.

Port of ``interactvlm_tpu/models/sam/mask_decoder.py``. Names follow the SAM
checkpoint (``output_upscaling.0.weight``, ``output_hypernetworks_mlps.{i}
.layers.{j}.weight`` ...); the upscaling convolutions permute to
channels-first around the call.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from interactvlm_tpu_torch.config import SAMConfig
from interactvlm_tpu_torch.models.layers import (
    ConvTranspose2d,
    LayerNorm,
    Linear,
)
from interactvlm_tpu_torch.models.sam.transformer import TwoWayTransformer
from interactvlm_tpu_torch.utils.device import resolve_device


class MLP(nn.Module):
    def __init__(self, input_dim, hidden_dim, output_dim, num_layers, dtype,
                 device):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1], dtype=dtype, device=device)
            for i in range(num_layers))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, config: SAMConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        cfg = config
        self.config = cfg
        dim = cfg.prompt_embed_dim
        n_mask = cfg.num_mask_tokens
        kw = dict(dtype=cfg.dtype, device=device)
        self.iou_token = nn.Embedding(1, dim, **kw)
        self.mask_tokens = nn.Embedding(n_mask, dim, **kw)
        self.transformer = TwoWayTransformer(
            cfg.decoder_depth, dim, cfg.decoder_num_heads,
            cfg.decoder_mlp_dim, cfg.dtype, device)
        self.output_upscaling = nn.ModuleList([
            ConvTranspose2d(dim, dim // 4, 2, stride=2, **kw),
            LayerNorm(dim // 4, eps=1e-6, **kw),
            nn.GELU(),
            ConvTranspose2d(dim // 4, dim // 8, 2, stride=2, **kw),
            nn.GELU(),
        ])
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(dim, dim, dim // 8, 3, cfg.dtype, device)
            for _ in range(n_mask))
        self.iou_prediction_head = MLP(dim, cfg.iou_head_hidden_dim, n_mask,
                                       cfg.iou_head_depth, cfg.dtype, device)

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings, multimask_output: bool = False):
        """image_embeddings (B, g, g, C), image_pe (g, g, C), sparse
        (B, N, C), dense (B, g, g, C) -> (masks (B, n, 4g, 4g) f32, iou)."""
        n_mask = self.config.num_mask_tokens
        b = sparse_prompt_embeddings.shape[0]
        output_tokens = torch.cat([self.iou_token.weight,
                                   self.mask_tokens.weight], dim=0)
        tokens = torch.cat([output_tokens[None].expand(b, -1, -1),
                            sparse_prompt_embeddings], dim=1)
        src = image_embeddings + dense_prompt_embeddings
        pos_src = image_pe[None].expand(src.shape)
        g = src.shape[1]
        hs, keys = self.transformer(src, pos_src, tokens)
        iou_token_out = hs[:, 0]
        mask_tokens_out = hs[:, 1:1 + n_mask]

        up0, ln, act0, up1, act1 = self.output_upscaling
        x = keys.reshape(b, g, g, -1).permute(0, 3, 1, 2)
        x = up0(x).permute(0, 2, 3, 1)
        x = act0(ln(x)).permute(0, 3, 1, 2)
        up = act1(up1(x)).permute(0, 2, 3, 1)  # (B, 4g, 4g, C/8)

        hyper_in = torch.stack(
            [mlp(mask_tokens_out[:, i])
             for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1)
        # bf16 products are exact in f32: an f32 product accumulates in f32
        masks = torch.einsum("bnc,bhwc->bnhw", hyper_in.float(), up.float())
        iou_pred = self.iou_prediction_head(iou_token_out)
        if multimask_output:
            return masks[:, 1:], iou_pred[:, 1:]
        return masks[:, :1], iou_pred[:, :1]
