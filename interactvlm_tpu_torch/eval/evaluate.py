"""Generate-mode evaluation of one batch (port of
``interactvlm_tpu/eval/evaluate.py:evaluate_batch`` and
``_evaluate_batch_multiseg``).

The path mirrors the reference ``model.evaluate`` (InteractVLM.py:510-637):
cut each prompt before its answer, greedy-decode with hidden capture, take
the hidden state that predicted the first emitted seg token (or, with K > 1
slots, each of the first K), run the SAM tail over the multi-view renders
(or their cached embedding) with the decoder the contact type (or the
slot's token) selects, upsample, and lift the masks: onto the body mesh
(hcontact), an object's point cloud (oafford, per-sample pixel -> point
maps) or an object mesh (ocontact, per-sample maps; or one object's maps,
the demo's path).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from interactvlm_tpu_torch.geometry.lift import (
    lift_multiview_points,
    lift_multiview_thresholded,
)
from interactvlm_tpu_torch.models.generate import greedy_generate
from interactvlm_tpu_torch.models.interactvlm import (
    InteractVLM,
    lift_human,
    lift_object,
)
from interactvlm_tpu_torch.models.sam.sam import postprocess_masks
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
                   max_seg_tokens: int = 1,
                   object_maps: Optional[Dict] = None,
                   meta: Optional[Dict] = None):
    """Generate-mode inference for one batch on the model's device.

    ``batch`` holds input_ids, labels (numpy or tensors), images_clip
    (B, S, S, 3), sam_images (B, V, S, S, 3) and cam_params (B, V, 5), and
    for the object lifts ``obj_p2p`` (B, V, H, W) (oafford) or corner-major
    ``obj_p2v`` / ``obj_bary`` (3, B, V, H, W) with ``gt_ocontact`` (B, N)
    (ocontact). ``human_maps`` and ``object_maps`` hold corner-major
    ``p2v``/``bary`` (3, V, H, W) and optionally ``num_vertices``.
    ``kv_cache`` is "dense" or "int8" (the LLaMA decode cache).
    ``cached_image_emb`` ((1, V, g, g, C)) is the frozen-encoder embedding
    of the fixed canonical renders; it skips the SAM encode. ``meta`` with
    ``resize_list`` and ``label_list`` adds ``pred_masks_original``, one
    (H0, W0) mask a sample in its original frame. ``contact_type`` selects
    the DifDe decoder and the lift.

    Returns tensors on the model's device: generated_ids (B, T),
    pred_masks (B, V, mask_size, mask_size), pred_masks_original (a list,
    or None), pred_contact_3d (B, N) or None, and has_seg (B,). With
    ``max_seg_tokens`` K > 1, see ``_evaluate_batch_multiseg``.
    """
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
    is_seg = torch.isin(gen_ids, torch.tensor(model.seg_ids, device=dev))
    has_seg = is_seg.any(dim=1)
    if max_seg_tokens > 1:
        return _evaluate_batch_multiseg(
            model, batch, mask_size, gen_ids, is_seg, gen["step_hidden"],
            max_seg_tokens, human_maps, object_maps, cached_image_emb,
            contact_type)
    first = torch.where(has_seg, is_seg.int().argmax(dim=1), 0)
    rows = torch.arange(gen_ids.shape[0], device=dev)
    seg_hidden = gen["step_hidden"][rows, first]  # the predictor hidden
    token_id = gen_ids[rows, first]

    cams = torch.as_tensor(batch["cam_params"], device=dev)
    if cached_image_emb is not None:
        low = model.low_res_masks_from_image_emb(
            seg_hidden, token_id, cached_image_emb, cams, contact_type)
    else:
        sam_px = torch.as_tensor(batch["sam_images"], device=dev).to(cfg.sam.dtype)
        low = model.low_res_masks_from_seg_hidden(seg_hidden, token_id,
                                                  sam_px, cams, contact_type)
    pred_masks = model.upsample_masks(low, mask_size)
    pred_masks = torch.where(has_seg[:, None, None, None], pred_masks, 0.0)

    # real-photo 2D tasks: crop the pad, then resize to each sample's
    # original size (reference sam.py:137-172); sizes vary a sample
    pred_masks_original = None
    if meta is not None and "resize_list" in meta and "label_list" in meta:
        pred_masks_original = [
            postprocess_masks(low[b:b + 1, :1], cfg.sam.img_size,
                              tuple(meta["resize_list"][b]),
                              np.asarray(meta["label_list"][b]).shape[:2]
                              )[0, 0] * has_seg[b]
            for b in range(gen_ids.shape[0])]

    pred_contact_3d = None
    if "hcontact" in contact_type and human_maps is not None:
        pred_contact_3d = lift_human(
            pred_masks, _dev(human_maps["p2v"], dev),
            _dev(human_maps["bary"], dev),
            int(human_maps.get("num_vertices", cfg.num_human_vertices)))
    elif "oafford" in contact_type and "obj_p2p" in batch:
        # per-sample pixel -> point maps; sigmoid heatmap values averaged
        # per point and visible view (reference components.py:318-347)
        p2p = _dev(batch["obj_p2p"], dev)
        pred_contact_3d = torch.stack([
            lift_multiview_points(m, p, cfg.num_object_points)
            for m, p in zip(torch.sigmoid(pred_masks), p2p)])
    elif "ocontact" in contact_type and "obj_p2v" in batch:
        pred_contact_3d = lift_objects_per_sample(
            pred_masks, batch, batch["gt_ocontact"].shape[1], dev)
    elif object_maps is not None:
        # the demo: one object's maps (reference InteractVLM.py:624-628)
        pred_contact_3d = lift_object(
            pred_masks, _dev(object_maps["p2v"], dev),
            _dev(object_maps["bary"], dev),
            int(object_maps.get("num_vertices", cfg.num_object_points)))
    if pred_contact_3d is not None:
        # rows without a seg token predict nothing (InteractVLM.py:621)
        pred_contact_3d = torch.where(has_seg[:, None], pred_contact_3d, 0.0)
    return {
        "generated_ids": gen_ids,
        "pred_masks": pred_masks,
        "pred_masks_original": pred_masks_original,
        "pred_contact_3d": pred_contact_3d,
        "has_seg": has_seg,
    }


def _dev(x, dev):
    return torch.as_tensor(x, device=dev)


def lift_objects_per_sample(masks, batch, n_out: int, dev):
    """Thresholded lifts (0.3) of (B, V, H, W) logits on per-sample
    corner-major object maps (3, B, V, H, W) (reference components.py:
    350-489) -> (B, n_out)."""
    p2v, bary = _dev(batch["obj_p2v"], dev), _dev(batch["obj_bary"], dev)
    return torch.stack([
        lift_multiview_thresholded(m, p2v[:, b], bary[:, b], n_out)
        for b, m in enumerate(masks)])


def seg_slots(gen_ids, is_seg, step_hidden, K: int):
    """The first K seg tokens of each row, in emission order: (their
    predictor hidden states (B, K, H), their ids (B, K), valid (B, K));
    an empty slot holds zeros."""
    T = gen_ids.shape[1]
    pos_all = torch.where(is_seg, torch.arange(T, device=gen_ids.device), T)
    pos = torch.topk(pos_all, K, dim=1, largest=False, sorted=True).values
    valid = pos < T
    posc = pos.clamp(max=T - 1)
    hidden = torch.gather(step_hidden, 1, posc[..., None].expand(
        posc.shape + step_hidden.shape[-1:]))
    hidden = torch.where(valid[..., None], hidden, 0.0).to(step_hidden.dtype)
    return hidden, torch.where(valid, torch.gather(gen_ids, 1, posc), 0), valid


@torch.inference_mode()
def _evaluate_batch_multiseg(model: InteractVLM, batch: Dict, mask_size: int,
                            gen_ids, is_seg, step_hidden, K: int,
                            human_maps: Optional[Dict] = None,
                            object_maps: Optional[Dict] = None,
                            cached_image_emb=None,
                            contact_type: str = "hcontact"):
    """K-slot decode from a generation's output: one mask set per emitted
    seg token, up to K a row in emission order (reference
    InteractVLM.py:544-576; the slots fold into the decode batch). A
    function of ``gen_ids`` (B, T), ``is_seg`` (B, T) and ``step_hidden``
    (B, T, H), so any ids can be handed in. Each slot decodes with its
    token's DifDe decoder. Slots are routed by token: [HSEG] or [SEG] slots
    lift through ``human_maps``, [OSEG] slots through the batch's
    per-sample object maps or ``object_maps``; each row lifts its first
    slot of a kind.

    Returns generated_ids, pred_masks_k (B, K, V, M, M), token_ids_k and
    valid_k (B, K), pred_hcontact_3d and pred_ocontact_3d ((B, N), zero for
    a row without such a slot, or None), and the single-token fields:
    pred_masks (the first slot's set), pred_contact_3d (the human lift for
    an hcontact ``contact_type``, else the object lift), has_seg, and
    pred_masks_original (None).
    """
    cfg = model.config
    dev = model.device
    gen_ids, is_seg = gen_ids.to(dev), is_seg.to(dev)
    B = gen_ids.shape[0]
    has_seg = is_seg.any(1)
    seg_h_k, tok_k, valid_k = seg_slots(gen_ids, is_seg, step_hidden.to(dev),
                                        K)
    cams = _dev(batch["cam_params"], dev)
    image_emb = cached_image_emb
    if image_emb is None:
        image_emb = model.encode_sam_images(
            _dev(batch["sam_images"], dev).to(cfg.sam.dtype))
    low_k = model.multi_seg_low_res_masks(seg_h_k, tok_k, valid_k, image_emb,
                                          cams)  # (B, K, V, h, w)
    V = low_k.shape[2]
    pred_k = model.upsample_masks(
        low_k.reshape((B * K, V) + low_k.shape[3:]), mask_size
    ).reshape(B, K, V, mask_size, mask_size)

    rows = torch.arange(B, device=dev)
    is_h_slot = ((tok_k == cfg.seg_token_idx) | (tok_k == cfg.hseg_token_idx)
                 ) & valid_k
    is_o_slot = (tok_k == cfg.oseg_token_idx) & valid_k
    any_h, any_o = is_h_slot.any(1), is_o_slot.any(1)
    h_slot = torch.where(any_h, is_h_slot.int().argmax(1), 0)
    o_slot = torch.where(any_o, is_o_slot.int().argmax(1), 0)

    pred_h3d = pred_o3d = None
    if human_maps is not None and bool(any_h.any()):
        pred_h3d = lift_human(
            pred_k[rows, h_slot], _dev(human_maps["p2v"], dev),
            _dev(human_maps["bary"], dev),
            int(human_maps.get("num_vertices", cfg.num_human_vertices))
        ) * any_h[:, None]
    if bool(any_o.any()):
        masks_o = pred_k[rows, o_slot]
        if "obj_p2v" in batch:
            n_out = (batch["gt_ocontact"].shape[1] if "gt_ocontact" in batch
                     else cfg.num_object_points)
            pred_o3d = lift_objects_per_sample(masks_o, batch, n_out, dev)
        elif object_maps is not None:
            pred_o3d = lift_object(
                masks_o, _dev(object_maps["p2v"], dev),
                _dev(object_maps["bary"], dev),
                int(object_maps.get("num_vertices", cfg.num_object_points)))
        if pred_o3d is not None:
            pred_o3d = pred_o3d * any_o[:, None]

    return {
        "generated_ids": gen_ids,
        "pred_masks": pred_k[:, 0] * has_seg[:, None, None, None],
        "pred_masks_original": None,
        "pred_masks_k": pred_k,
        "token_ids_k": tok_k,
        "valid_k": valid_k,
        "pred_hcontact_3d": pred_h3d,
        "pred_ocontact_3d": pred_o3d,
        "pred_contact_3d": pred_h3d if "hcontact" in contact_type else pred_o3d,
        "has_seg": has_seg,
    }
