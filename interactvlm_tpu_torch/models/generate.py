"""Greedy autoregressive decoding with hidden-state capture.

Port of ``interactvlm_tpu/models/generate.py``: prefill into a dense or
int8 KV cache, then a Python loop of decode steps (the JAX package's ``lax.scan``).
The hidden state that predicted each emitted token is kept so [SEG]-token
embeddings can be gathered afterwards.
"""

from __future__ import annotations

from typing import Optional

import torch

from interactvlm_tpu_torch.models.llava import LlavaModel


@torch.inference_mode()
def greedy_generate(model: LlavaModel, input_ids, pixels,
                    max_new_tokens: int = 32, eos_id: int = 2,
                    attn_mask: Optional[torch.Tensor] = None,
                    kv_cache: str = "dense"):
    """Greedy decode on the model's device.

    input_ids: (B, L) prompt with one IMAGE_TOKEN_INDEX per row, right-padded
    with ``attn_mask`` marking valid tokens; pixels: (B, S, S, 3); kv_cache:
    "dense" or "int8".
    Returns generated_ids (B, T) (eos after a row stops), step_hidden
    (B, T, H), prompt_hidden, prompt_spliced_ids and prompt_len.
    """
    B, L = input_ids.shape
    Lp = L - 1 + model.clip_config.num_patches
    (last_logits, prompt_hidden, caches, spliced_ids, prompt_len,
     first_hidden) = model.prefill(input_ids, pixels, Lp + max_new_tokens,
                                   attn_mask, kv_cache)
    tok = last_logits.argmax(-1).to(torch.int32)
    done = tok == eos_id
    pos = prompt_len.to(torch.int32)
    toks, hiddens = [tok], [first_hidden]
    for _ in range(max_new_tokens - 1):
        logits, hidden, caches = model.decode_step(tok, pos, caches)
        nxt = logits.argmax(-1).to(torch.int32)
        nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        hiddens.append(torch.where(done[:, None], torch.zeros_like(hidden),
                                   hidden))
        toks.append(nxt)
        done = done | (nxt == eos_id)
        tok, pos = nxt, pos + 1
    return {
        "generated_ids": torch.stack(toks, dim=1),
        "step_hidden": torch.stack(hiddens, dim=1),
        "prompt_hidden": prompt_hidden,
        "prompt_spliced_ids": spliced_ids,
        "prompt_len": prompt_len,
    }
