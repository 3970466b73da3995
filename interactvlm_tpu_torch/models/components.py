"""InteractVLM heads around the backbones (port of
``interactvlm_tpu/models/components.py``): the [SEG] projection, the three
camera-pose encoders, the human/object attention splitter, and the
optional fusion and uncertainty heads.

``TextHiddenFcs`` keeps the reference's module layout
(``text_hidden_fcs.0.0`` / ``.0.2``: a list holding Linear-ReLU-Linear-
Dropout), so the merged InteractVLM checkpoint loads by key. The other
heads name their layers as the JAX package does (``spatial1``, ``view_0``,
``query_human``, ``sam_proj``, ...).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from interactvlm_tpu_torch.models.layers import Linear
from interactvlm_tpu_torch.ops.attention import dot_product_attention


class TextHiddenFcs(nn.ModuleList):
    """[SEG] hidden-state projection hidden_size -> out_dim
    (reference InteractVLM.py:103-109)."""

    def __init__(self, hidden_size: int, out_dim: int, dtype, device):
        kw = dict(dtype=dtype, device=device)
        super().__init__([nn.Sequential(
            Linear(hidden_size, hidden_size, **kw), nn.ReLU(),
            Linear(hidden_size, out_dim, **kw), nn.Dropout(0.0),
        )])

    def forward(self, x):
        return self[0](x)


class CamPoseEncoder(nn.Module):
    """'simple': Linear + ReLU on the 5-dof cam params, ADDED to each view's
    prompt embedding (reference components.py:491-508)."""

    def __init__(self, output_dim: int, dtype, device):
        super().__init__()
        self.linear1 = Linear(5, output_dim, dtype=dtype, device=device)

    def forward(self, cam_params):
        return F.relu(self.linear1(cam_params))


class _PerViewHeads(nn.Module):
    """One Linear a view, ``view_0`` ... ``view_{V-1}``: head v maps view v
    of a (..., V, C) input."""

    def __init__(self, num_views: int, in_dim: int, output_dim: int, dtype,
                 device):
        super().__init__()
        self.num_views = num_views
        for v in range(num_views):
            setattr(self, f"view_{v}", Linear(in_dim, output_dim, dtype=dtype,
                                              device=device))

    def heads(self, x):
        return [getattr(self, f"view_{v}")(x[..., v, :])
                for v in range(self.num_views)]


class ViewIndexCamPoseEncoder(_PerViewHeads):
    """'view_index': shared spatial MLP, sigmoid, then one head a view; the
    output MULTIPLIES the embedding (reference components.py:510-539)."""

    def __init__(self, num_views: int, output_dim: int, dtype, device):
        super().__init__(num_views, output_dim, output_dim, dtype, device)
        kw = dict(dtype=dtype, device=device)
        self.spatial1 = Linear(5, output_dim, **kw)
        self.spatial2 = Linear(output_dim, output_dim, **kw)

    def forward(self, cam_params):
        """cam_params (..., V, 5) -> (..., V, output_dim)."""
        base = torch.sigmoid(self.spatial2(F.relu(self.spatial1(cam_params))))
        return torch.stack(self.heads(base), dim=-2)


class VIv1CamPoseEncoder(_PerViewHeads):
    """'vi_v1': a two-layer ReLU spatial MLP, then one head a view with a
    sigmoid after each (reference components.py:541-572)."""

    def __init__(self, num_views: int, output_dim: int, dtype, device,
                 hidden_dim: int = 128):
        super().__init__(num_views, hidden_dim, output_dim, dtype, device)
        kw = dict(dtype=dtype, device=device)
        self.spatial1 = Linear(5, hidden_dim, **kw)
        self.spatial2 = Linear(hidden_dim, hidden_dim, **kw)

    def forward(self, cam_params):
        h = F.relu(self.spatial2(F.relu(self.spatial1(cam_params))))
        return torch.stack([torch.sigmoid(o) for o in self.heads(h)], dim=-2)


class AttentionSplitter(nn.Module):
    """Splits the view tokens into human and object variants with two query
    heads over shared keys and values, and ONE output projection shared by
    both (token types Gen-Hu-Obj / Gen-Int; reference components.py:155-193).
    The attention runs over a sample's V tokens: plain matmul and softmax."""

    def __init__(self, input_dim: int, dtype, device, hidden_dim: int = 128):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.hidden_dim = hidden_dim
        self.input_proj = Linear(input_dim, hidden_dim, **kw)
        self.key = Linear(hidden_dim, hidden_dim, **kw)
        self.value = Linear(hidden_dim, hidden_dim, **kw)
        self.query_human = Linear(hidden_dim, hidden_dim, **kw)
        self.query_object = Linear(hidden_dim, hidden_dim, **kw)
        self.output_proj = Linear(hidden_dim, input_dim, **kw)

    def forward(self, x):
        """x (..., N, input_dim) -> (human, object), each of x's shape."""
        h = self.input_proj(x)
        k, v = self.key(h), self.value(h)
        scale = self.hidden_dim ** -0.5

        def attend(q):
            probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale,
                                  dim=-1)
            return self.output_proj(torch.matmul(probs, v))

        return attend(self.query_human(h)), attend(self.query_object(h))


class LLaVASAMFusion(nn.Module):
    """Cross-attention of the SAM image embedding (queries, g*g tokens) over
    the LLaVA hidden states (keys and values), added back onto the embedding
    (reference components.py:112-153; off in released configurations).
    ``num_heads`` heads of ``fusion_dim // num_heads``; the attention goes
    through ``ops/attention.py:dot_product_attention``, so at g*g >= 512 on
    the card it launches the flash kernel. Padded LLaVA positions are not
    masked, as in the JAX package."""

    def __init__(self, sam_embed_dim: int, llava_embed_dim: int, dtype,
                 device, fusion_dim: int = 128, num_heads: int = 8):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.fusion_dim, self.num_heads = fusion_dim, num_heads
        self.sam_proj = Linear(sam_embed_dim, fusion_dim, **kw)
        self.llava_proj = Linear(llava_embed_dim, fusion_dim, **kw)
        self.q_proj = Linear(fusion_dim, fusion_dim, **kw)
        self.k_proj = Linear(fusion_dim, fusion_dim, **kw)
        self.v_proj = Linear(fusion_dim, fusion_dim, **kw)
        self.attn_out = Linear(fusion_dim, fusion_dim, **kw)
        self.output_proj = Linear(fusion_dim, sam_embed_dim, **kw)

    def forward(self, sam_embeddings, llava_features):
        """sam_embeddings (B, g, g, C), llava_features (B, L, H) ->
        (B, g, g, C)."""
        B, g, _, C = sam_embeddings.shape
        sq = self.sam_proj(sam_embeddings.reshape(B, g * g, C))
        lk = self.llava_proj(llava_features)
        d = self.fusion_dim // self.num_heads

        def split(x):
            return x.reshape(B, x.shape[1], self.num_heads, d).transpose(1, 2)

        fused = dot_product_attention(split(self.q_proj(sq)),
                                      split(self.k_proj(lk)),
                                      split(self.v_proj(lk)))
        fused = fused.transpose(1, 2).reshape(B, g * g, self.fusion_dim)
        out = self.output_proj(self.attn_out(fused))
        return sam_embeddings + out.reshape(B, g, g, C)


class UncertaintyModule(nn.Module):
    """Per-pixel softplus uncertainty head (reference components.py:40-78;
    off in released configurations, and called nowhere)."""

    def __init__(self, in_dim: int, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.linear1 = Linear(in_dim, 64, **kw)
        self.linear2 = Linear(64, 16, **kw)
        self.linear3 = Linear(16, 1, **kw)

    def forward(self, x):
        """x (B, g, g, C) -> (B, g, g, 1)."""
        h = F.relu(self.linear2(F.relu(self.linear1(x))))
        return F.softplus(self.linear3(h))
