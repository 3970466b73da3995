"""LLaMA decoder in PyTorch with a dense KV cache.

Port of ``interactvlm_tpu/models/llama.py`` (dense bf16 path): RMSNorm in
f32, HF rotate-half rotary embeddings, SwiGLU MLP, and attention in three
modes: no cache, prefill over a fresh cache, and decode over a filled dense
cache. Module and parameter names are those of HF ``LlamaForCausalLM``
(``model.layers.{i}.self_attn.q_proj.weight`` ...), so an HF state dict
loads by key. Causal prefill with at least 256 tokens launches the flash
kernel on CUDA with per-row kv lengths (``models/llama.py:409-420``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from interactvlm_tpu_torch.config import LlamaConfig
from interactvlm_tpu_torch.models.layers import Linear
from interactvlm_tpu_torch.ops.attention import dot_product_attention
from interactvlm_tpu_torch.ops.flash_attention import flash_attention
from interactvlm_tpu_torch.utils.device import resolve_device

KVCache = Dict[str, Any]  # {"k", "v": (B, Lmax, nkv, d), "valid": (B, Lmax), "index": int}

FLASH_MIN_PREFILL = 256
MASK_BIAS = -1e9


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.out_dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))

    def forward(self, x):
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(self.out_dtype)


def rope_cos_sin(positions, head_dim: int, theta: float):
    """HF-convention rotary tables in f32: (..., L, head_dim), frequency
    halves duplicated."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=positions.device) / head_dim))
    angles = positions[..., None].float() * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x: (B, L, n, d); cos/sin: (B, L, d) -> rotated x (HF rotate_half)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    cos, sin = cos[..., None, :], sin[..., None, :]
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


def _padding_bias(attn_mask):
    return torch.where(attn_mask[:, None, None, :] > 0, 0.0,
                       MASK_BIAS).to(torch.float32)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device):
        super().__init__()
        c = config
        self.config = c
        kw = dict(bias=False, dtype=c.dtype, device=device)
        self.q_proj = Linear(c.hidden_size, c.num_heads * c.head_dim, **kw)
        self.k_proj = Linear(c.hidden_size, c.num_kv_heads * c.head_dim, **kw)
        self.v_proj = Linear(c.hidden_size, c.num_kv_heads * c.head_dim, **kw)
        self.o_proj = Linear(c.num_heads * c.head_dim, c.hidden_size, **kw)

    def forward(self, x, positions, attn_mask=None,
                cache: Optional[KVCache] = None, fresh_cache: bool = True):
        """Returns (out, cache). A given cache is updated in place (k/v rows,
        key-validity row and cursor) and returned."""
        cfg = self.config
        B, L, _ = x.shape
        nh, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = self.q_proj(x).view(B, L, nh, d)
        k = self.k_proj(x).view(B, L, nkv, d)
        v = self.v_proj(x).view(B, L, nkv, d)
        cos, sin = rope_cos_sin(positions, d, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        bias, causal, kv_lengths = None, True, None
        if cache is not None:
            idx = cache["index"]
            cache["k"][:, idx:idx + L] = k.to(cache["k"].dtype)
            cache["v"][:, idx:idx + L] = v.to(cache["v"].dtype)
            cache["valid"][:, idx:idx + L] = (
                attn_mask.to(torch.int8) if attn_mask is not None else 1)
            cache["index"] = idx + L
            if L > 1 and fresh_cache:
                # a prompt chunk over a fresh cache attends causally within
                # the chunk over its exact k/v
                if attn_mask is not None:
                    kv_lengths = attn_mask.sum(-1).to(torch.int32)
                    bias = _padding_bias(attn_mask)
            else:
                # keys past idx + L are invalid, causal within the chunk,
                # padded key slots (valid == 0) never attended; slots past
                # idx + L carry -1e9 in the full-cache form, so leaving them
                # out changes nothing
                Lk = idx + L
                kpos = torch.arange(Lk, device=x.device)[None, :]
                qpos = torch.arange(L, device=x.device)[:, None]
                visible = (kpos <= idx + qpos)[None] & (
                    cache["valid"][:, None, :Lk] > 0)
                bias = torch.where(visible, 0.0, MASK_BIAS).to(
                    torch.float32)[:, None]
                causal = False
                k = cache["k"][:, :Lk].to(x.dtype)
                v = cache["v"][:, :Lk].to(x.dtype)
        elif attn_mask is not None:
            kv_lengths = attn_mask.sum(-1).to(torch.int32)
            bias = _padding_bias(attn_mask)

        if nkv != nh:
            k = k.repeat_interleave(nh // nkv, dim=2)
            v = v.repeat_interleave(nh // nkv, dim=2)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        if causal and x.is_cuda and L >= FLASH_MIN_PREFILL:
            out = flash_attention(qh.contiguous(), kh.contiguous(),
                                  vh.contiguous(), causal=True,
                                  kv_lengths=kv_lengths)
        else:
            out = dot_product_attention(qh, kh, vh, bias=bias, causal=causal)
        out = out.transpose(1, 2).reshape(B, L, nh * d)
        return self.o_proj(out), cache


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, device):
        super().__init__()
        kw = dict(bias=False, dtype=config.dtype, device=device)
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = Linear(h, i, **kw)
        self.up_proj = Linear(h, i, **kw)
        self.down_proj = Linear(i, h, **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device):
        super().__init__()
        c = config
        self.self_attn = LlamaAttention(c, device)
        self.mlp = LlamaMLP(c, device)
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps,
                                       c.dtype, device)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps,
                                                c.dtype, device)

    def forward(self, x, positions, attn_mask=None, cache=None,
                fresh_cache=True):
        attn, cache = self.self_attn(self.input_layernorm(x), positions,
                                     attn_mask, cache, fresh_cache)
        x = x + attn
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, cache


class LlamaModel(nn.Module):
    """Decoder stack over embeddings (LLaVA feeds spliced embeddings)."""

    def __init__(self, config: LlamaConfig, device):
        super().__init__()
        c = config
        self.config = c
        self.embed_tokens = nn.Embedding(c.padded_vocab_size, c.hidden_size,
                                         dtype=c.dtype, device=device)
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(c, device) for _ in range(c.num_layers))
        self.norm = RMSNorm(c.hidden_size, c.rms_norm_eps, c.dtype, device)

    def forward(self, inputs_embeds, positions=None, attn_mask=None,
                caches: Optional[List[KVCache]] = None,
                fresh_cache: bool = True):
        """Returns (hidden (B, L, H) after the final norm, caches)."""
        B, L, _ = inputs_embeds.shape
        if positions is None:
            positions = torch.arange(L, device=inputs_embeds.device)[None].expand(B, L)
        x = inputs_embeds
        for i, layer in enumerate(self.layers):
            x, _ = layer(x, positions, attn_mask,
                         caches[i] if caches is not None else None,
                         fresh_cache)
        return self.norm(x), caches


class LlamaForCausalLM(nn.Module):
    def __init__(self, config: LlamaConfig, device="cuda"):
        super().__init__()
        if config.weights_int8 or config.weights_int4 or config.lora_rank:
            raise NotImplementedError(
                "int8/int4 weights and LoRA are not ported yet")
        device = resolve_device(device)
        self.config = config
        self.model = LlamaModel(config, device)
        self.lm_head = Linear(config.hidden_size, config.padded_vocab_size,
                              bias=False, dtype=config.dtype, device=device)

    def logits(self, h):
        """lm_head with the vocab-pad columns masked to -1e30."""
        out = self.lm_head(h)
        cfg = self.config
        if cfg.padded_vocab_size != cfg.vocab_size:
            out[..., cfg.vocab_size:] = -1e30
        return out

    def embed(self, input_ids):
        return self.model.embed_tokens(input_ids)

    def forward(self, input_ids, attn_mask=None):
        h, _ = self.model(self.embed(input_ids), attn_mask=attn_mask)
        return self.logits(h), h

    def forward_embeds(self, inputs_embeds, positions=None, attn_mask=None,
                       caches=None, fresh_cache=True):
        h, caches = self.model(inputs_embeds, positions, attn_mask, caches,
                               fresh_cache)
        return self.logits(h), h, caches


def init_kv_cache(config: LlamaConfig, batch: int, max_len: int, device,
                  dtype=None) -> List[KVCache]:
    """Fresh per-layer dense KV caches."""
    dtype = dtype or config.dtype
    shape = (batch, max_len, config.num_kv_heads, config.head_dim)
    return [
        {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "valid": torch.zeros(batch, max_len, dtype=torch.int8,
                                 device=device),
            "index": 0,
        }
        for _ in range(config.num_layers)
    ]
