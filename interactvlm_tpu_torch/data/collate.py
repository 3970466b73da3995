"""Batch assembly: canonical samples -> fixed-shape batch of torch tensors.

Port of ``interactvlm_tpu/data/collate.py``, itself a rebuild of the
reference ``collate_fn`` (``datasets/dataset.py:31-178``). The arrays are
the JAX package's, element for element and in its layouts ((B, V, S, S, 3)
``sam_images``, corner-major (3, V, H, W) lift maps), so nothing is
transposed per batch; each becomes a torch tensor here, in pinned host
memory when ``pin_memory`` is set, which the training step copies to the
card with ``non_blocking=True`` (``to_device``). The large image and mask
stacks are written straight into their (pinned) tensors. The JAX
package's changes to the reference stay:
- the 14-field per-sample tuple becomes a typed ``Sample``;
- single-view images/masks/cams are repeated to V views
  (dataset.py:68-75);
- sequences pad to a static ``max_len`` (minus the 255 image-embedding
  expansion like the reference's truncation, dataset.py:151-157);
- dataset-name strings are encoded as integer task ids; ragged per-sample
  fields (paths, class names) ride along as host-side lists.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from interactvlm_tpu_torch.data.tokenization import tokenize_conversations
from interactvlm_tpu_torch.geometry.lift import corner_major
from interactvlm_tpu_torch.utils.constants import TASK_IDS


def task_id_for(ds_name: str) -> int:
    for key, tid in TASK_IDS.items():
        if key in ds_name:
            return tid
    return 1


@dataclasses.dataclass
class Sample:
    """Canonical per-sample record (reference field list,
    e.g. hcontact_3d.py:352-366)."""

    image_path: str
    sam_images: np.ndarray  # (V or 1, S, S, 3) normalized
    image_clip: np.ndarray  # (Sc, Sc, 3) normalized
    conversations: List[str]
    masks: np.ndarray  # (V or 1, H, W) float with IGNORE -1
    label: np.ndarray  # (H, W) original-frame label
    gt_contact_3d: np.ndarray  # (N,) task-dependent
    cam_params: np.ndarray  # (V or 1, 5) normalized
    resize: tuple
    questions: List[str]
    sampled_classes: List[str]
    ds_name: str
    mask_paths: List[str]
    inference: bool = False
    # per-sample object lift maps (reference loads them per sample from
    # paths derived from the mask paths, model/components.py:309, :363-377)
    obj_p2p: Optional[np.ndarray] = None  # (V, H, W) int32, -1 invalid
    obj_p2v: Optional[np.ndarray] = None  # (V, H, W, 3) int32, -1 invalid
    obj_bary: Optional[np.ndarray] = None  # (V, H, W, 3) float32
    num_valid_verts: int = 0  # real vertex count (ocontact meshes)
    # per-seg-token GT mask sets for conversations carrying MORE than one
    # seg token ([HSEG]+[OSEG] interaction answers): (K, V or 1, H, W) in
    # token EMISSION order, like the reference's positional masks_list
    # alignment (InteractVLM.py:436-442). None = single-token sample
    # (slot 0 is ``masks``).
    masks_k: Optional[np.ndarray] = None


def _repeat_views(x: np.ndarray, V: int) -> np.ndarray:
    if x.shape[0] == 1 and V > 1:
        return np.repeat(x, V, axis=0)
    return x


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _stack(arrays, pin: bool) -> torch.Tensor:
    """``np.stack(arrays)`` written straight into a new (pinned) tensor."""
    first = np.asarray(arrays[0])
    out = torch.empty((len(arrays),) + first.shape,
                      dtype=_torch_dtype(first.dtype), pin_memory=pin)
    np.stack(arrays, out=out.numpy())
    return out


def _tensors(batch: Dict[str, Any], pin: bool) -> Dict[str, torch.Tensor]:
    """Every numpy array of ``batch`` as a tensor (pinned with ``pin``);
    tensors stay as they are (the human maps, converted once at load)."""
    out = {}
    for k, v in batch.items():
        if not torch.is_tensor(v):
            v = torch.from_numpy(np.ascontiguousarray(v))
            v = v.pin_memory() if pin else v
        out[k] = v
    return out


def to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """The batch's tensors on ``device``, copied without a host sync (from
    pinned memory the copy overlaps the card's work); other values as
    they are."""
    return {k: v.to(device, non_blocking=True) if torch.is_tensor(v) else v
            for k, v in batch.items()}


def collate(
    samples: Sequence[Sample],
    tokenizer,
    max_len: int = 512,
    conv_type: str = "llava_v1",
    use_mm_start_end: bool = True,
    multiview_channels: int = 4,
    num_human_vertices: int = 6890,
    num_object_points: int = 2048,
    human_maps: Optional[Dict[str, np.ndarray]] = None,
    include_maps: bool = True,
    include_object_maps: bool = False,
    max_object_vertices: int = 8192,
    num_conversations: int = 1,
    max_seg_tokens: int = 1,
    pin_memory: bool = False,
) -> Dict[str, Any]:
    """Returns the model batch dict (torch tensors on the host, pinned with
    ``pin_memory``) plus host-side metadata lists.

    ``num_conversations`` > 1 restores the reference's multi-conversation
    ``offset`` semantics (datasets sample up to 3 classes per image,
    ``datasets/dataset.py:196,216-246``; per-sample unpack
    ``InteractVLM.py:392-410``) in static-shape form: the batch has
    exactly ``B * C`` conversation ROWS, ``images_clip`` / ``sam_images``
    stay compact (one entry per image), and ``image_index`` maps rows to
    images so each image is encoded ONCE. Samples with fewer than C
    conversations contribute padding rows whose labels are all-IGNORE,
    whose task id is VQA (no mask loss), and whose gt masks are IGNORE
    everywhere -- they contribute exactly zero loss.

    ``max_seg_tokens`` > 1 emits K-slot GT masks ``gt_masks`` (B, K, V, H,
    W) plus a ``seg_slot_has_mask`` (B, K) indicator -- one mask set per
    seg token of the row's conversation, positionally aligned with token
    emission order like the reference's masks_list (InteractVLM.py:
    436-442). Single-token samples fill slot 0 from ``masks``; samples
    with ``masks_k`` fill their K sets; unfilled slots are IGNORE with a
    zero indicator.
    """
    V = multiview_channels
    if num_conversations > 1:
        # the reference's C>1 mixtures are the LISA-legacy seg tasks
        # (sem/refer/reason + VQA, dataset.py:196); object-contact
        # datasets always use one conversation per image
        assert not include_object_maps, (
            "multi-conversation collate does not carry object lift maps; "
            "train object datasets with num_conversations=1"
        )
        assert max_seg_tokens == 1, (
            "multi-conversation rows are one-seg-token by construction "
            "(one sampled class per conversation); K-slot GT masks apply "
            "to the num_conversations=1 interaction mixtures"
        )
        return _collate_multiconv(
            samples, tokenizer, max_len, conv_type, use_mm_start_end,
            V, num_human_vertices, num_object_points, human_maps,
            include_maps, num_conversations, pin_memory,
        )
    conversations = [s.conversations[0] for s in samples]
    tok = tokenize_conversations(
        conversations, tokenizer,
        max_len=max_len - 255 if not samples[0].inference else max_len,
        conv_type=conv_type, use_mm_start_end=use_mm_start_end,
    )

    sam_images = _stack([_repeat_views(s.sam_images, V) for s in samples],
                        pin_memory)
    masks_t = _stack([_repeat_views(np.asarray(s.masks, np.float32), V)
                      for s in samples], pin_memory)
    masks = masks_t.numpy()
    cams = np.stack([_repeat_views(s.cam_params, V) for s in samples])
    task_ids = np.array([task_id_for(s.ds_name) for s in samples], np.int32)

    B = len(samples)
    gt_h = np.zeros((B, num_human_vertices), np.float32)
    gt_oa = np.zeros((B, num_object_points), np.float32)
    for i, s in enumerate(samples):
        tid = task_ids[i]
        v = np.asarray(s.gt_contact_3d, np.float32).reshape(-1)
        if tid == 2 and v.size == num_human_vertices:
            gt_h[i] = v
        elif tid == 3 and v.size == num_object_points:
            gt_oa[i] = v

    gt_masks = masks_t
    seg_slot_has_mask = None
    if max_seg_tokens > 1:
        K = max_seg_tokens
        _, Vv, Hm, Wm = masks.shape
        gtk = np.full((B, K, Vv, Hm, Wm), -1.0, np.float32)  # IGNORE
        seg_slot_has_mask = np.zeros((B, K), np.float32)
        for i, s in enumerate(samples):
            if s.masks_k is not None:
                mk = np.asarray(s.masks_k, np.float32)
                n = min(mk.shape[0], K)
                for k in range(n):
                    gtk[i, k] = _repeat_views(mk[k], V)
                seg_slot_has_mask[i, :n] = 1.0
            else:
                gtk[i, 0] = masks[i]
                seg_slot_has_mask[i, 0] = float(task_ids[i] != 0)
        gt_masks = gtk

    batch = {
        "input_ids": tok["input_ids"],
        "labels": tok["labels"],
        "attn_mask": tok["attn_mask"],
        "images_clip": _stack([s.image_clip for s in samples], pin_memory),
        "sam_images": sam_images,
        "gt_masks": gt_masks,
        "cam_params": cams.astype(np.float32),
        "task_ids": task_ids,
        "gt_hcontact": gt_h,
        "gt_oafford": gt_oa,
    }
    if seg_slot_has_mask is not None:
        batch["seg_slot_has_mask"] = seg_slot_has_mask
    if include_maps and human_maps is not None:
        # the lifts take corner-major (3, V, H, W) maps, converted ONCE at
        # load (train._load_human_maps), not here: eval also reads the dict
        assert human_maps["p2v"].shape[0] == 3, human_maps["p2v"].shape
        batch["human_p2v"] = torch.as_tensor(human_maps["p2v"])
        batch["human_bary"] = torch.as_tensor(human_maps["bary"])
    if include_object_maps:
        # fixed-shape per-sample object lift maps; rows without maps carry
        # -1 (invalid everywhere -> their lift scatters nothing). The flag
        # is per-RUN (set when the mixture contains object datasets) so
        # every batch of a run has the same keys.
        Hm, Wm = masks.shape[-2], masks.shape[-1]
        obj_p2p = np.full((B, V, Hm, Wm), -1, np.int32)
        obj_p2v = np.full((B, V, Hm, Wm, 3), -1, np.int32)
        obj_bary = np.zeros((B, V, Hm, Wm, 3), np.float32)
        valid_verts = np.zeros((B, max_object_vertices), np.float32)
        gt_oc = np.zeros((B, max_object_vertices), np.float32)
        for i, s in enumerate(samples):
            if s.obj_p2p is not None:
                obj_p2p[i] = _repeat_views(
                    np.asarray(s.obj_p2p, np.int32), V
                )
            if s.obj_p2v is not None:
                obj_p2v[i] = _repeat_views(
                    np.asarray(s.obj_p2v, np.int32), V
                )
                obj_bary[i] = _repeat_views(
                    np.asarray(s.obj_bary, np.float32), V
                )
            if task_ids[i] == 4:
                v = np.asarray(s.gt_contact_3d, np.float32).reshape(-1)[
                    :max_object_vertices
                ]
                gt_oc[i, : v.size] = v
                n = int(s.num_valid_verts) or v.size
                valid_verts[i, : min(n, max_object_vertices)] = 1.0
        batch.update(
            obj_p2p=obj_p2p,
            obj_p2v=corner_major(obj_p2v),   # (3, B, V, H, W)
            obj_bary=corner_major(obj_bary),
            obj_valid_verts=valid_verts, gt_ocontact=gt_oc,
        )

    meta = {
        "image_paths": [s.image_path for s in samples],
        "conversation_list": conversations,
        "resize_list": [s.resize for s in samples],
        "label_list": [s.label for s in samples],
        "questions_list": [s.questions for s in samples],
        "sampled_classes_list": [s.sampled_classes for s in samples],
        "ds_name_list": [s.ds_name for s in samples],
        "mask_paths_list": [s.mask_paths for s in samples],
        "inference": samples[0].inference,
    }
    return _tensors(batch, pin_memory), meta


def _conv_masks(s: Sample, ci: int, V: int) -> np.ndarray:
    """Row mask stack for conversation ``ci`` of sample ``s``.

    Multi-conversation samples carry masks (C, H, W) -- one per sampled
    class, single view; contact samples carry (V or 1, H, W) views."""
    m = np.asarray(s.masks)
    if len(s.conversations) > 1:
        return np.repeat(m[ci][None], V, axis=0)
    return _repeat_views(m, V)


def _collate_multiconv(
    samples, tokenizer, max_len, conv_type, use_mm_start_end, V,
    num_human_vertices, num_object_points, human_maps, include_maps, C,
    pin_memory=False,
):
    B = len(samples)
    rows = []  # (sample_idx, conv_idx, is_pad)
    for i, s in enumerate(samples):
        n = min(len(s.conversations), C)
        rows.extend((i, ci, False) for ci in range(n))
    while len(rows) < B * C:
        rows.append((0, 0, True))
    rows = rows[: B * C]

    conversations = [samples[i].conversations[ci] for i, ci, _ in rows]
    tok = tokenize_conversations(
        conversations, tokenizer,
        max_len=max_len - 255 if not samples[0].inference else max_len,
        conv_type=conv_type, use_mm_start_end=use_mm_start_end,
    )
    labels = np.asarray(tok["labels"])
    for r, (_, _, pad) in enumerate(rows):
        if pad:
            labels[r] = -100  # zero CE contribution

    image_index = np.array([i for i, _, _ in rows], np.int32)
    task_ids = np.array(
        [0 if pad else task_id_for(samples[i].ds_name)
         for i, _, pad in rows], np.int32,
    )
    masks = np.stack([
        np.full_like(_conv_masks(samples[i], ci, V), -1.0)
        if pad else _conv_masks(samples[i], ci, V)
        for i, ci, pad in rows
    ])
    cams = np.stack(
        [_repeat_views(np.asarray(samples[i].cam_params), V)
         for i, _, _ in rows]
    )

    R = len(rows)
    gt_h = np.zeros((R, num_human_vertices), np.float32)
    gt_oa = np.zeros((R, num_object_points), np.float32)
    for r, (i, _, pad) in enumerate(rows):
        if pad:
            continue
        v = np.asarray(samples[i].gt_contact_3d, np.float32).reshape(-1)
        if task_ids[r] == 2 and v.size == num_human_vertices:
            gt_h[r] = v
        elif task_ids[r] == 3 and v.size == num_object_points:
            gt_oa[r] = v

    batch = {
        "input_ids": tok["input_ids"],
        "labels": labels,
        "attn_mask": tok["attn_mask"],
        "images_clip": _stack([s.image_clip for s in samples], pin_memory),
        "sam_images": _stack(
            [_repeat_views(np.asarray(s.sam_images), V) for s in samples],
            pin_memory,
        ),
        "image_index": image_index,
        "gt_masks": masks.astype(np.float32),
        "cam_params": cams.astype(np.float32),
        "task_ids": task_ids,
        "gt_hcontact": gt_h,
        "gt_oafford": gt_oa,
    }
    if include_maps and human_maps is not None:
        assert human_maps["p2v"].shape[0] == 3, human_maps["p2v"].shape
        batch["human_p2v"] = torch.as_tensor(human_maps["p2v"])
        batch["human_bary"] = torch.as_tensor(human_maps["bary"])

    meta = {
        "image_paths": [samples[i].image_path for i, _, _ in rows],
        "conversation_list": conversations,
        "resize_list": [samples[i].resize for i, _, _ in rows],
        "label_list": [samples[i].label for i, _, _ in rows],
        "questions_list": [samples[i].questions for i, _, _ in rows],
        "sampled_classes_list": [
            samples[i].sampled_classes[ci: ci + 1] for i, ci, _ in rows
        ],
        "ds_name_list": [samples[i].ds_name for i, _, _ in rows],
        "mask_paths_list": [samples[i].mask_paths for i, _, _ in rows],
        "row_map": [(i, ci, pad) for i, ci, pad in rows],
        "inference": samples[0].inference,
    }
    return _tensors(batch, pin_memory), meta
