"""SAM two-way (token <-> image) transformer in PyTorch.

Port of ``interactvlm_tpu/models/sam/transformer.py``. Every attention goes
through the shared dispatch: the image -> token attention (Lq = 4096 image
tokens at ViT-H, Lk = 9 prompt tokens, head dim 16) launches the flash
kernel on CUDA, as on the TPU. The LayerNorms use eps 1e-6, the JAX
package's (flax default) value; the reference SAM uses torch's 1e-5 there.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from interactvlm_tpu_torch.models.layers import LayerNorm, Linear
from interactvlm_tpu_torch.ops.attention import dot_product_attention

LN_EPS = 1e-6


class Attention(nn.Module):
    """Attention with optional internal downsampling (reference :185-242)."""

    def __init__(self, embedding_dim: int, num_heads: int,
                 downsample_rate: int, dtype, device):
        super().__init__()
        internal = embedding_dim // downsample_rate
        self.num_heads = num_heads
        kw = dict(dtype=dtype, device=device)
        self.q_proj = Linear(embedding_dim, internal, **kw)
        self.k_proj = Linear(embedding_dim, internal, **kw)
        self.v_proj = Linear(embedding_dim, internal, **kw)
        self.out_proj = Linear(internal, embedding_dim, **kw)

    def forward(self, q, k, v):
        def split(x):
            b, n, c = x.shape
            return x.view(b, n, self.num_heads, c // self.num_heads).transpose(1, 2)

        out = dot_product_attention(split(self.q_proj(q)),
                                    split(self.k_proj(k)),
                                    split(self.v_proj(v)))
        b, h, n, d = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, h * d))


class MLPBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.lin1 = Linear(dim, mlp_dim, **kw)
        self.lin2 = Linear(mlp_dim, dim, **kw)

    def forward(self, x):
        return self.lin2(F.relu(self.lin1(x)))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int,
                 downsample: int, skip_first_layer_pe: bool, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = Attention(dim, num_heads, 1, dtype, device)
        self.norm1 = LayerNorm(dim, eps=LN_EPS, **kw)
        self.cross_attn_token_to_image = Attention(dim, num_heads, downsample,
                                                   dtype, device)
        self.norm2 = LayerNorm(dim, eps=LN_EPS, **kw)
        self.mlp = MLPBlock(dim, mlp_dim, dtype, device)
        self.norm3 = LayerNorm(dim, eps=LN_EPS, **kw)
        self.cross_attn_image_to_token = Attention(dim, num_heads, downsample,
                                                   dtype, device)
        self.norm4 = LayerNorm(dim, eps=LN_EPS, **kw)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)

        q = queries + query_pe
        k = keys + key_pe
        queries = self.norm2(
            queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))

        q = queries + query_pe
        k = keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int, embedding_dim: int, num_heads: int,
                 mlp_dim: int, dtype, device, attention_downsample_rate=2):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim,
                                 attention_downsample_rate, i == 0, dtype,
                                 device)
            for i in range(depth))
        self.final_attn_token_to_image = Attention(
            embedding_dim, num_heads, attention_downsample_rate, dtype, device)
        self.norm_final_attn = LayerNorm(embedding_dim, eps=LN_EPS,
                                         dtype=dtype, device=device)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding/image_pe: (B, H, W, C) channels-last;
        point_embedding: (B, N, C). Returns (queries, keys_flat)."""
        b, c = image_embedding.shape[0], image_embedding.shape[-1]
        keys = image_embedding.reshape(b, -1, c)
        key_pe = image_pe.reshape(b, -1, c)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q = queries + point_embedding
        k = keys + key_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys
