"""LLaMA decoder in PyTorch with a dense or int8 KV cache, LoRA and QLoRA.

Port of ``interactvlm_tpu/models/llama.py`` (serving and training paths):
RMSNorm in f32, HF rotate-half rotary embeddings, SwiGLU MLP, and attention
in three modes: no cache, prefill over a fresh cache, and decode over a
filled dense or int8 cache. Module and parameter names are those of HF
``LlamaForCausalLM`` (``model.layers.{i}.self_attn.q_proj.weight`` ...), so
an HF state dict loads by key. Causal attention over at least 256 tokens
launches the flash kernel on CUDA with per-row kv lengths
(``models/llama.py:409-420``), differentiable through its backward kernels.
Under ``weights_int8`` every projection, the MLP and the lm_head are
``Int8Linear`` (int8 ``weight`` plus ``weight_scale``), which on CUDA launch
the fused int8 kernel; under ``weights_int4`` they are ``Int4Linear``
(packed ``weight_q4``, ``weight_scale``, ``weight_rf``), kernel 6 on the
unpacked weight. With ``lora_rank > 0`` q_proj and v_proj are
``LoraLinear`` (peft's ``lora_A`` / ``lora_B``) over a bf16 base, or under
``weights_int8`` ``Int8LoraLinear`` over a frozen int8 base (QLoRA: the
straight-through backward), and the lm_head stays in the compute dtype and
trains; with ``remat`` each decoder layer is recomputed in the backward
(``nn.remat(LlamaBlock)``), which launches its flash forward, and its
int8 linears, a second time.

Given a ``mesh`` (``parallel/mesh.py``) whose model axis has n ranks, the
decoder is tensor-parallel as the JAX package's is over its ``model`` axis:
each rank builds nh / n query heads and nkv / n kv heads (q/k/v
column-parallel, o_proj row-parallel), I / n MLP columns (gate/up column,
down row), and padded_vocab / n rows of ``embed_tokens`` (vocab-parallel)
and of the lm_head (column-parallel); ``logits`` masks the pad columns at
their global indices and gathers the vocabulary over the model ranks, so
the logits, the hidden states after the final norm and everything after
them are whole on every rank. A KV cache holds the rank's own heads.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from interactvlm_tpu_torch.config import LlamaConfig
from interactvlm_tpu_torch.models.layers import (
    Embedding,
    Int4Linear,
    Int8Linear,
    Int8LoraLinear,
    Linear,
    LoraLinear,
    shard_layer,
)
from interactvlm_tpu_torch.parallel.collectives import batch_sum, gather_from
from interactvlm_tpu_torch.ops.attention import dot_product_attention
from interactvlm_tpu_torch.ops.flash_attention import flash_attention
from interactvlm_tpu_torch.ops.quant import append_kv_cache_int8
from interactvlm_tpu_torch.utils.device import resolve_device

# {"k", "v": (B, Lmax, nkv, d), "valid": (B, Lmax), "index": int}, plus
# "k_scale", "v_scale" (B, Lmax, nkv, 1) f32 for an int8 cache (k, v int8)
KVCache = Dict[str, Any]

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


def _model_ranks(mesh) -> int:
    return 1 if mesh is None else mesh.n_model


def linear(config: LlamaConfig, in_features: int, out_features: int, device,
           lora: bool = False, int8: bool = None, int4: bool = None,
           mesh=None, kind: str = "column"):
    """A bias-free projection (the JAX package's ``_dense`` and
    ``LoraDense``): where ``lora`` and ``lora_rank > 0``, ``Int8LoraLinear``
    under ``weights_int8`` (QLoRA) and ``LoraLinear`` over a float base
    otherwise; else ``Int4Linear`` under ``weights_int4`` (which takes
    precedence), ``Int8Linear`` under ``weights_int8``. ``int8`` / ``int4``
    override the config's flags (the lm_head's). With a ``mesh`` the layer
    is built at this rank's size and split over its model axis, ``kind``
    "column" (out features) or "row" (in features)."""
    n = _model_ranks(mesh)
    if kind == "column":
        out_features //= n
    else:
        in_features //= n
    layer = _linear(config, in_features, out_features, device, lora, int8,
                    int4)
    return shard_layer(layer, kind, mesh)


def _linear(config, in_features, out_features, device, lora, int8, int4):
    c = config
    int8 = c.weights_int8 if int8 is None else int8
    int4 = c.weights_int4 if int4 is None else int4
    if lora and c.lora_rank > 0:
        cls = Int8LoraLinear if c.weights_int8 else LoraLinear
        return cls(in_features, out_features, c.lora_rank, c.lora_alpha,
                   dtype=c.dtype, device=device)
    if int4:
        return Int4Linear(in_features, out_features, dtype=c.dtype,
                          device=device)
    if int8:
        return Int8Linear(in_features, out_features, dtype=c.dtype,
                          device=device)
    return Linear(in_features, out_features, bias=False, dtype=c.dtype,
                  device=device)


def _padding_bias(attn_mask):
    return torch.where(attn_mask[:, None, None, :] > 0, 0.0,
                       MASK_BIAS).to(torch.float32)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device, mesh=None):
        super().__init__()
        c = config
        self.config = c
        n = _model_ranks(mesh)
        # this rank's query and kv heads
        self.num_heads = c.num_heads // n
        self.num_kv_heads = c.num_kv_heads // n
        self.q_proj = linear(c, c.hidden_size, c.num_heads * c.head_dim, device,
                             lora=True, mesh=mesh)
        self.k_proj = linear(c, c.hidden_size, c.num_kv_heads * c.head_dim,
                             device, mesh=mesh)
        self.v_proj = linear(c, c.hidden_size, c.num_kv_heads * c.head_dim,
                             device, lora=True, mesh=mesh)
        self.o_proj = linear(c, c.num_heads * c.head_dim, c.hidden_size,
                             device, mesh=mesh, kind="row")

    def forward(self, x, positions, attn_mask=None,
                cache: Optional[KVCache] = None, fresh_cache: bool = True):
        """Returns (out, cache). A given cache is updated in place (k/v rows,
        key-validity row and cursor) and returned."""
        cfg = self.config
        B, L, _ = x.shape
        nh, nkv, d = self.num_heads, self.num_kv_heads, cfg.head_dim
        q = self.q_proj(x).view(B, L, nh, d)
        k = self.k_proj(x).view(B, L, nkv, d)
        v = self.v_proj(x).view(B, L, nkv, d)
        cos, sin = rope_cos_sin(positions, d, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        bias, causal, kv_lengths = None, True, None
        if cache is not None:
            idx = cache["index"]
            int8_cache = "k_scale" in cache
            if int8_cache:
                append_kv_cache_int8(cache, k, v)
            else:
                cache["k"][:, idx:idx + L] = k.to(cache["k"].dtype)
                cache["v"][:, idx:idx + L] = v.to(cache["v"].dtype)
                cache["index"] = idx + L
            cache["valid"][:, idx:idx + L] = (
                attn_mask.to(torch.int8) if attn_mask is not None else 1)
            if L > 1 and fresh_cache:
                # a prompt chunk over a fresh cache attends causally within
                # the chunk over its exact (for an int8 cache: not yet
                # quantized) k/v
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
                if int8_cache:
                    out = _int8_cache_attention(q, cache, Lk, bias, nh)
                    return self.o_proj(out.reshape(B, L, nh * d)), cache
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


def _int8_cache_attention(q, cache, Lk: int, bias, nh: int):
    """Attention of q (B, L, nh, d) over the first Lk slots of an int8
    cache, with the per-position scales folded in (the JAX package's
    ``models/llama.py:371-395``): logits in f32 from the int8 keys, times
    d^-1/2, times the k scales, plus the mask bias; softmax; times the v
    scales; then the probabilities in q's dtype times the int8 values,
    summed in f32. Every int8 value is exact in bf16, so widening it to f32
    directly equals the JAX package's cast to the compute dtype. No
    dequantized cache is kept. Returns (B, L, nh, d) in q's dtype."""
    d = q.shape[-1]
    kq, vq = cache["k"][:, :Lk], cache["v"][:, :Lk]
    ks, vs = cache["k_scale"][:, :Lk, :, 0], cache["v_scale"][:, :Lk, :, 0]
    if kq.shape[2] != nh:
        rep = nh // kq.shape[2]
        kq, vq = kq.repeat_interleave(rep, 2), vq.repeat_interleave(rep, 2)
        ks, vs = ks.repeat_interleave(rep, 2), vs.repeat_interleave(rep, 2)
    dt = q.dtype
    qh = q.transpose(1, 2).float()  # (B, nh, L, d)
    kh = kq.permute(0, 2, 3, 1).float()  # (B, nh, d, Lk)
    logits = torch.matmul(qh, kh) * d ** -0.5
    logits = logits * ks.transpose(1, 2)[:, :, None, :]
    probs = torch.softmax(logits + bias, dim=-1)
    probs = probs * vs.transpose(1, 2)[:, :, None, :]
    vh = vq.transpose(1, 2).float()  # (B, nh, Lk, d)
    out = torch.matmul(probs.to(dt).float(), vh).to(dt)
    return out.transpose(1, 2)


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, device, mesh=None):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = linear(config, h, i, device, mesh=mesh)
        self.up_proj = linear(config, h, i, device, mesh=mesh)
        self.down_proj = linear(config, i, h, device, mesh=mesh, kind="row")

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device, mesh=None):
        super().__init__()
        c = config
        self.self_attn = LlamaAttention(c, device, mesh)
        self.mlp = LlamaMLP(c, device, mesh)
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

    def __init__(self, config: LlamaConfig, device, mesh=None):
        super().__init__()
        c = config
        self.config = c
        self.embed_tokens = shard_layer(
            Embedding(c.padded_vocab_size // _model_ranks(mesh),
                      c.hidden_size, dtype=c.dtype, device=device),
            "vocab", mesh)
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(c, device, mesh) for _ in range(c.num_layers))
        self.norm = RMSNorm(c.hidden_size, c.rms_norm_eps, c.dtype, device)

    def forward(self, inputs_embeds, positions=None, attn_mask=None,
                caches: Optional[List[KVCache]] = None,
                fresh_cache: bool = True):
        """Returns (hidden (B, L, H) after the final norm, caches). Under
        ``remat`` and grad each layer keeps only its input for the backward
        and runs again there."""
        B, L, _ = inputs_embeds.shape
        if positions is None:
            positions = torch.arange(L, device=inputs_embeds.device)[None].expand(B, L)
        remat = (self.config.remat and caches is None
                 and torch.is_grad_enabled())
        x = inputs_embeds
        for i, layer in enumerate(self.layers):
            if remat:
                x, _ = checkpoint(layer, x, positions, attn_mask, None,
                                  fresh_cache, use_reentrant=False)
            else:
                x, _ = layer(x, positions, attn_mask,
                             caches[i] if caches is not None else None,
                             fresh_cache)
        return self.norm(x), caches


class LlamaForCausalLM(nn.Module):
    def __init__(self, config: LlamaConfig, device="cuda", mesh=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.mesh = mesh
        self.n_model = _model_ranks(mesh)
        self.model = LlamaModel(config, device, mesh)
        # int8 / int4 as the serving weights are (lora_rank 0, the JAX
        # package's serving head); with lora_rank > 0 (QLoRA included) it
        # stays in the compute dtype and trains
        serving = config.lora_rank == 0
        self.lm_head = linear(config, config.hidden_size,
                              config.padded_vocab_size, device,
                              int8=config.weights_int8 and serving,
                              int4=config.weights_int4 and serving,
                              mesh=mesh)

    def logits(self, h):
        """lm_head with the vocab-pad columns masked to -1e30; under tensor
        parallelism each rank masks its columns at their global indices,
        and the vocabulary is gathered over the model ranks."""
        out = self.lm_head(h)
        cfg = self.config
        if self.n_model > 1:
            cols = out.shape[-1]
            first = self.mesh.model_index * cols
            if first + cols > cfg.vocab_size:
                pad = torch.arange(first, first + cols,
                                   device=out.device) >= cfg.vocab_size
                out = out.masked_fill(pad, -1e30)
            return gather_from(out, self.mesh.model_group)
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
                  dtype=None, n_model: int = 1) -> List[KVCache]:
    """Fresh per-layer dense KV caches; under tensor parallelism over
    ``n_model`` ranks a rank caches its own nkv / n_model heads."""
    dtype = dtype or config.dtype
    shape = (batch, max_len, config.num_kv_heads // n_model, config.head_dim)
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


def cross_entropy_loss(logits, labels, ignore_index: int = -100):
    """Shifted causal-LM cross entropy: f32 log-softmax, targets equal to
    ``ignore_index`` masked, mean over the valid targets (HF
    ``LlamaForCausalLM`` semantics; the JAX package's
    ``cross_entropy_loss``), over the global batch where the rows are split
    over data ranks (``parallel/collectives.py:batch_group``)."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    shift = labels[:, 1:].long()
    valid = shift != ignore_index
    ll = logp.gather(-1, torch.where(valid, shift, 0)[..., None])[..., 0]
    return -batch_sum((ll * valid).sum()) / batch_sum(
        valid.sum()).clamp_min(1)
