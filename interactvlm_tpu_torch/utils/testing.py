"""Synthetic training batches for tests, the card's smoke run and
benchmarks.

Port of ``interactvlm_tpu/utils/testing.py:make_synthetic_batch``: the batch
dict of the data pipeline (the reference ``collate_fn``'s keys), drawn from
``np.random.default_rng(seed)`` in the JAX package's order, so the same
arguments give the same arrays. Images are zeros, as there.
"""

from __future__ import annotations

import numpy as np
import torch

from interactvlm_tpu_torch.config import InteractVLMConfig
from interactvlm_tpu_torch.utils.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from interactvlm_tpu_torch.utils.device import resolve_device


def make_synthetic_batch(cfg: InteractVLMConfig, B: int = 2, L: int = 12,
                         tasks=(2, 3), mask_size: int = 32, seed: int = 0,
                         device="cuda"):
    """Random ids with ``<image>`` at position 1 and the seg token at
    ``L - 2`` (``[HSEG]`` / ``[OSEG]`` at ``L - 4`` / ``L - 2`` when
    ``max_seg_tokens > 1``), labels on the last three positions, random GT
    masks with two IGNORE rows, camera parameters, task ids cycling through
    ``tasks``, 3D contact and affordance targets, and random corner-major
    lift maps. Returns a dict of tensors on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    V = cfg.multiview_channels
    vocab = cfg.llama.vocab_size
    ids = rng.integers(4, min(vocab, 32000) - 1, (B, L)).astype(np.int32)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    K = cfg.max_seg_tokens
    if K > 1:
        hseg = cfg.hseg_token_idx if cfg.hseg_token_idx > 0 else cfg.seg_token_idx
        oseg = cfg.oseg_token_idx if cfg.oseg_token_idx > 0 else cfg.seg_token_idx
        ids[:, L - 4] = hseg
        ids[:, L - 2] = oseg
    else:
        ids[:, L - 2] = cfg.seg_token_idx
    labels = np.full((B, L), IGNORE_INDEX, np.int32)
    labels[:, L - 3:] = ids[:, L - 3:]
    labels[:, L - 3] = 9
    Nh, P = cfg.num_human_vertices, cfg.num_object_points
    S, Sc, M = cfg.sam.img_size, cfg.clip.image_size, mask_size

    gt_masks = (rng.random((B, V, M, M)) > 0.7).astype(np.float32)
    gt_masks[:, :, :2] = -1.0
    extra = {}
    if K > 1:
        # slot 0 the row's primary mask, slot 1 a second mask set, the
        # other slots IGNORE (the collate's max_seg_tokens layout)
        gtk = np.full((B, K, V, M, M), -1.0, np.float32)
        gtk[:, 0] = gt_masks
        second = (rng.random((B, V, M, M)) > 0.6).astype(np.float32)
        second[:, :, :2] = -1.0
        gtk[:, 1] = second
        gt_masks = gtk
        has = np.zeros((B, K), np.float32)
        has[:, :2] = 1.0
        extra["seg_slot_has_mask"] = has

    p2v = rng.integers(0, Nh, (V, M, M, 3)).astype(np.int32)
    p2v[:, :M // 2] = -1
    bary = rng.dirichlet([1, 1, 1], (V, M, M)).astype(np.float32)
    p2p = rng.integers(-1, P, (B, V, M, M)).astype(np.int32)
    arrays = {
        **extra,
        "input_ids": ids,
        "labels": labels,
        "gt_masks": gt_masks,
        "cam_params": rng.random((B, V, 5)).astype(np.float32),
        "task_ids": np.resize(np.array(tasks), B).astype(np.int32),
        "gt_hcontact": (rng.random((B, Nh)) > 0.8).astype(np.float32),
        "gt_oafford": rng.random((B, P)).astype(np.float32),
        # corner-major (3, V, H, W): see geometry/lift.corner_major
        "human_p2v": np.ascontiguousarray(np.moveaxis(p2v, -1, 0)),
        "human_bary": np.ascontiguousarray(np.moveaxis(bary, -1, 0)),
        "obj_p2p": p2p,
    }
    batch = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
    batch["images_clip"] = torch.zeros((B, Sc, Sc, 3), device=dev)
    batch["sam_images"] = torch.zeros((B, V, S, S, 3), device=dev)
    return batch
