"""Generate-mode evaluation of one batch (port of the ``hcontact`` branch of
``interactvlm_tpu/eval/evaluate.py:evaluate_batch``).

The path mirrors the reference ``model.evaluate`` (InteractVLM.py:510-637):
cut each prompt before its answer, greedy-decode with hidden capture, take
the hidden state that predicted the first emitted seg token, run the SAM
tail over the multi-view renders (or their cached embedding), upsample, and
lift the masks onto the body mesh.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from interactvlm_tpu_torch.models.generate import greedy_generate
from interactvlm_tpu_torch.models.interactvlm import InteractVLM, lift_human
from interactvlm_tpu_torch.utils.constants import IGNORE_INDEX


def truncate_at_answer(input_ids: np.ndarray, labels: np.ndarray,
                       pad_id: int = 0):
    """Cut each row's prompt right before its first supervised token
    (reference evaluate.py:88-92, per row). Returns (ids (B, W), attn_mask
    (B, W)) right-padded to the widest row."""
    B, L = input_ids.shape
    starts = []
    for b in range(B):
        pos = np.nonzero(labels[b] != IGNORE_INDEX)[0]
        starts.append(int(pos[0]) if pos.size > 0 else L)
    width = max(starts)
    out = np.full((B, width), pad_id, dtype=input_ids.dtype)
    mask = np.zeros((B, width), dtype=np.int32)
    for b, s in enumerate(starts):
        out[b, :s] = input_ids[b, :s]
        mask[b, :s] = 1
    return out, mask


def _numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@torch.inference_mode()
def evaluate_batch(model: InteractVLM, batch: Dict, mask_size: int,
                   contact_type: str = "hcontact", max_new_tokens: int = 32,
                   human_maps: Optional[Dict] = None, eos_id: int = 2,
                   kv_cache: str = "dense", cached_image_emb=None,
                   max_seg_tokens: int = 1):
    """Generate-mode inference for one hcontact batch on the model's device.

    ``batch`` holds input_ids, labels (numpy or tensors), images_clip
    (B, S, S, 3), sam_images (B, V, S, S, 3) and cam_params (B, V, 5).
    ``human_maps`` holds corner-major ``p2v``/``bary`` (3, V, H, W) and
    optionally ``num_vertices``. ``kv_cache`` is "dense" or "int8" (the
    LLaMA decode cache). ``cached_image_emb`` ((1, V, g, g, C)) is
    the frozen-encoder embedding of the fixed canonical renders; it skips
    the SAM encode. Returns tensors on the model's device: generated_ids
    (B, T), pred_masks (B, V, mask_size, mask_size), pred_contact_3d (B, N)
    or None, and has_seg (B,).
    """
    if "hcontact" not in contact_type:
        raise NotImplementedError(f"contact type {contact_type!r} is not ported yet")
    if max_seg_tokens != 1:
        raise NotImplementedError("multi-seg-token evaluation is not ported yet")
    cfg = model.config
    dev = model.device
    ids_np, mask_np = truncate_at_answer(_numpy(batch["input_ids"]),
                                         _numpy(batch["labels"]))
    ids = torch.as_tensor(ids_np, dtype=torch.long, device=dev)
    attn_mask = torch.as_tensor(mask_np, device=dev)
    clip_px = torch.as_tensor(batch["images_clip"], device=dev).to(cfg.clip.dtype)
    gen = greedy_generate(model.llava, ids, clip_px,
                          max_new_tokens=max_new_tokens, eos_id=eos_id,
                          attn_mask=attn_mask, kv_cache=kv_cache)
    gen_ids = gen["generated_ids"]
    is_seg = gen_ids == cfg.seg_token_idx
    has_seg = is_seg.any(dim=1)
    first = torch.where(has_seg, is_seg.int().argmax(dim=1), 0)
    rows = torch.arange(gen_ids.shape[0], device=dev)
    seg_hidden = gen["step_hidden"][rows, first]  # the predictor hidden
    token_id = gen_ids[rows, first]

    cams = torch.as_tensor(batch["cam_params"], device=dev)
    if cached_image_emb is not None:
        low = model.low_res_masks_from_image_emb(
            seg_hidden, token_id, cached_image_emb, cams)
    else:
        sam_px = torch.as_tensor(batch["sam_images"], device=dev).to(cfg.sam.dtype)
        low = model.low_res_masks_from_seg_hidden(seg_hidden, token_id,
                                                  sam_px, cams)
    pred_masks = model.upsample_masks(low, mask_size)
    pred_masks = torch.where(has_seg[:, None, None, None], pred_masks, 0.0)

    pred_contact_3d = None
    if human_maps is not None:
        p2v = torch.as_tensor(human_maps["p2v"], device=dev)
        bary = torch.as_tensor(human_maps["bary"], device=dev)
        n = int(human_maps.get("num_vertices", cfg.num_human_vertices))
        pred_contact_3d = torch.where(
            has_seg[:, None], lift_human(pred_masks, p2v, bary, n), 0.0)
    return {
        "generated_ids": gen_ids,
        "pred_masks": pred_masks,
        "pred_contact_3d": pred_contact_3d,
        "has_seg": has_seg,
    }
