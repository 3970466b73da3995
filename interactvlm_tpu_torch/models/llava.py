"""LLaVA layer: CLIP tower + projector + LLaMA with image-token splicing.

Port of ``interactvlm_tpu/models/llava.py``. The <image> placeholder
(``IMAGE_TOKEN_INDEX``) of each row is replaced by the projected CLIP patch
embeddings through a static-shape gather (one image per sequence).
``seg_predictor_mask`` marks the position *preceding* each seg token, whose
hidden state predicted it (reference InteractVLM.py:331-341). ``forward``
is the teacher-forced pass of training; the frozen CLIP tower runs under
``torch.no_grad()`` there (the JAX package's ``stop_gradient``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn as nn

from interactvlm_tpu_torch.config import CLIPVisionConfig, LlamaConfig
from interactvlm_tpu_torch.models.clip_vit import CLIPVisionTower
from interactvlm_tpu_torch.models.layers import Linear
from interactvlm_tpu_torch.models.llama import LlamaForCausalLM, init_kv_cache
from interactvlm_tpu_torch.ops.quant import init_kv_cache_int8
from interactvlm_tpu_torch.utils.constants import (
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
    PATCH_ID,
)
from interactvlm_tpu_torch.utils.device import resolve_device


def splice_indices(input_ids, num_patches: int):
    """Gather indices for image splicing.

    For a row with IMAGE_TOKEN_INDEX at position ``i``: output[j] =
    text[j] for j < i, patch[j - i] for i <= j < i + P, text[j - P + 1]
    after. Returns (idx (B, Lout) into [text(L), patches(P)], is_patch
    (B, Lout), img_pos (B,), has_img (B,)).
    """
    B, L = input_ids.shape
    P = num_patches
    Lout = L - 1 + P
    is_img = input_ids == IMAGE_TOKEN_INDEX
    has_img = is_img.any(dim=1)
    img_pos = torch.where(has_img, is_img.int().argmax(dim=1),
                          torch.full_like(has_img, L, dtype=torch.long))
    j = torch.arange(Lout, device=input_ids.device)[None].expand(B, Lout)
    i = img_pos[:, None]
    is_patch = (j >= i) & (j < i + P)
    text_idx = torch.where(j < i, j, j - P + 1).clamp(0, L - 1)
    idx = torch.where(is_patch, L + (j - i).clamp(0, P - 1), text_idx)
    return idx, is_patch, img_pos, has_img


def splice_sequences(values, patch_values, idx, is_patch):
    """Gather spliced per-position values: values (B, L, ...) text-aligned,
    patch_values (B, P, ...) or None."""
    if patch_values is None:
        patch_values = torch.zeros((values.shape[0], 1) + values.shape[2:],
                                   dtype=values.dtype, device=values.device)
        idx = torch.where(is_patch, values.shape[1], idx)
    cat = torch.cat([values, patch_values.to(values.dtype)], dim=1)
    gidx = idx.reshape(idx.shape + (1,) * (values.ndim - 2)).expand(
        idx.shape + values.shape[2:])
    return torch.gather(cat, 1, gidx)


def splice_scalar(values, idx, is_patch, patch_fill):
    """Splice a (B, L) integer/bool sequence with a constant at patches."""
    fill = torch.full((values.shape[0], 1), patch_fill, dtype=values.dtype,
                      device=values.device)
    cat = torch.cat([values, fill], dim=1)
    return torch.gather(cat, 1, torch.where(is_patch, values.shape[1], idx))


def seg_predictor_mask(spliced_ids, seg_token_ids: Sequence[int]):
    """Mask over spliced positions whose NEXT token is a seg token."""
    is_seg = torch.zeros_like(spliced_ids, dtype=torch.bool)
    for t in seg_token_ids:
        is_seg = is_seg | (spliced_ids == t)
    return torch.cat([is_seg[:, 1:], torch.zeros_like(is_seg[:, :1])], dim=1)


@dataclasses.dataclass
class LlavaOutput:
    logits: torch.Tensor  # (B, Lout, V)
    hidden: torch.Tensor  # (B, Lout, H) after the final norm
    spliced_ids: torch.Tensor  # (B, Lout), PATCH_ID at patches
    spliced_labels: Optional[torch.Tensor]
    spliced_mask: torch.Tensor


class LlavaModel(nn.Module):
    """CLIP tower (frozen) + linear mm_projector + LLaMA decoder."""

    def __init__(self, llama_config: LlamaConfig,
                 clip_config: CLIPVisionConfig, device="cuda", mesh=None):
        super().__init__()
        device = resolve_device(device)
        self.llama_config = llama_config
        self.clip_config = clip_config
        self.vision_tower = CLIPVisionTower(clip_config, device)
        self.mm_projector = Linear(clip_config.hidden_size,
                                   llama_config.hidden_size,
                                   dtype=llama_config.dtype, device=device)
        # tensor-parallel over the mesh's model axis; CLIP and the projector
        # whole on every rank
        self.lm = LlamaForCausalLM(llama_config, device, mesh)

    @property
    def device(self):
        return self.mm_projector.weight.device

    def encode_images(self, pixels):
        """(B, S, S, 3) -> (B, P, hidden) projected patch embeddings. The
        tower is frozen: it runs without autograd."""
        with torch.no_grad():
            feats = self.vision_tower(pixels)
        return self.mm_projector(feats)

    def splice(self, input_ids, pixels, labels=None, attn_mask=None,
               image_index=None):
        """Spliced embeddings with aligned ids, labels and mask.
        ``image_index`` (B,) maps each row onto a compact batch of images,
        which ``pixels`` then holds, one encode each."""
        patches = self.encode_images(pixels)
        if image_index is not None:
            patches = patches[torch.as_tensor(image_index,
                                              device=patches.device).long()]
        P = patches.shape[1]
        idx, is_patch, _, has_img = splice_indices(input_ids, P)
        safe_ids = torch.where(input_ids == IMAGE_TOKEN_INDEX, 0,
                               input_ids).clamp(min=0)
        embeds = splice_sequences(self.lm.embed(safe_ids), patches, idx,
                                  is_patch)
        spliced_ids = splice_scalar(input_ids, idx, is_patch, PATCH_ID)
        spliced_labels = (splice_scalar(labels, idx, is_patch, IGNORE_INDEX)
                          if labels is not None else None)
        if attn_mask is None:
            attn_mask = (input_ids != 0).to(torch.int32)
        spliced_mask = splice_scalar(attn_mask, idx, is_patch, 1)
        # dummy patches of image-less rows are never attended
        spliced_mask = torch.where(is_patch & ~has_img[:, None], 0,
                                   spliced_mask)
        return embeds, spliced_ids, spliced_labels, spliced_mask

    def forward(self, input_ids, pixels, labels=None, attn_mask=None,
                image_index=None) -> LlavaOutput:
        """Teacher-forced pass over the spliced sequence: logits and final
        hidden states of every position, with the aligned ids, labels and
        mask."""
        embeds, spliced_ids, spliced_labels, spliced_mask = self.splice(
            input_ids, pixels, labels, attn_mask, image_index)
        logits, hidden, _ = self.lm.forward_embeds(embeds,
                                                   attn_mask=spliced_mask)
        return LlavaOutput(logits, hidden, spliced_ids, spliced_labels,
                           spliced_mask)

    def prefill(self, input_ids, pixels, max_len: int, attn_mask=None,
                kv_cache: str = "dense"):
        """Run the spliced prompt, filling a KV cache of ``max_len``:
        ``kv_cache`` "dense" (the compute dtype) or "int8" (quantized per
        position and head, ``ops/quant.py``).

        Returns (last_logits (B, V), hidden (B, Lp, H), caches,
        spliced_ids, prompt_len (B,), last_hidden (B, H)); the lm_head runs
        at each row's last valid position only.
        """
        embeds, spliced_ids, _, spliced_mask = self.splice(
            input_ids, pixels, None, attn_mask)
        B, Lp, _ = embeds.shape
        if kv_cache == "int8":
            caches = init_kv_cache_int8(self.llama_config, B, max_len,
                                        embeds.device, n_model=self.lm.n_model)
        elif kv_cache == "dense":
            caches = init_kv_cache(self.llama_config, B, max_len,
                                   embeds.device, n_model=self.lm.n_model)
        else:
            raise ValueError(f"unknown kv_cache {kv_cache!r}")
        positions = torch.arange(Lp, device=embeds.device)[None].expand(B, Lp)
        hidden, caches = self.lm.model(embeds, positions, spliced_mask,
                                       caches, True)
        prompt_len = spliced_mask.to(torch.int32).sum(-1)
        last = (prompt_len - 1).clamp(min=0).long()
        last_hidden = hidden[torch.arange(B, device=hidden.device), last]
        last_logits = self.lm.logits(last_hidden)
        return last_logits, hidden, caches, spliced_ids, prompt_len, last_hidden

    def decode_step(self, token_ids, position, caches):
        """One decode step. token_ids, position: (B,). Returns (logits
        (B, V), hidden (B, H), caches)."""
        embeds = self.lm.embed(token_ids[:, None])
        logits, hidden, caches = self.lm.forward_embeds(
            embeds, positions=position[:, None], caches=caches)
        return logits[:, -1], hidden[:, -1], caches
