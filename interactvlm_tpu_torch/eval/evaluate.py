"""Evaluation: generate-mode inference of one batch, the validation loop,
the DAMON contact reports and the evaluation CLI (port of
``interactvlm_tpu/eval/evaluate.py``: ``evaluate_batch``,
``_evaluate_batch_multiseg``, ``validate``, ``damon_binary_contact``,
``damon_semantic_contact`` and ``main``).

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

import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from interactvlm_tpu_torch.eval import metrics as M
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
from interactvlm_tpu_torch.utils.constants import (
    DAMON_CATEGORIES_MAPPING,
    IGNORE_INDEX,
)
from interactvlm_tpu_torch.utils.meters import AverageMeter, Summary


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
        pred_contact_3d = lift_points_per_sample(
            pred_masks, batch, cfg.num_object_points, dev)
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


def lift_points_per_sample(masks, batch, num_points: int, dev):
    """(B, V, H, W) logits lifted onto per-sample point clouds through
    their pixel -> point maps ``obj_p2p`` (B, V, H, W): the sigmoid heatmap
    values averaged per point and visible view (reference
    components.py:318-347) -> (B, num_points)."""
    p2p = _dev(batch["obj_p2p"], dev)
    return torch.stack([lift_multiview_points(m, p, num_points)
                        for m, p in zip(torch.sigmoid(masks), p2p)])


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
        if "oafford" in contact_type and "obj_p2p" in batch:
            # point clouds lift through their point maps, as the one-token
            # path lifts them (the JAX package's K-slot path takes the
            # mesh maps here, which a collated object batch also carries:
            # ROADMAP Queue C)
            pred_o3d = lift_points_per_sample(masks_o, batch,
                                              cfg.num_object_points, dev)
        elif "obj_p2v" in batch:
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


def _host(x):
    return None if x is None else _numpy(x)


def shard_eval_batches(batch_iter, mesh):
    """Distributed evaluation (the JAX package's ``shard_eval_batches``;
    the reference shards the val set with a DistributedSampler and
    all-gathers the predictions, evaluate.py:202-222,346): each global
    ``(batch, meta)`` becomes ``(batch, meta, local, local_meta, rows)``,
    this data rank's block of ceil(rows / n) rows, a short last batch
    padded by repeating its last row (``validate`` drops the padding when
    it gathers the predictions back in row order)."""
    from interactvlm_tpu_torch.train.train_step import take_rows

    n, r = mesh.n_data, mesh.data_index
    for batch, meta in batch_iter:
        rows = batch["input_ids"].shape[0]
        per = -(-rows // n)
        index = [min(i, rows - 1) for i in range(r * per, (r + 1) * per)]
        local_meta = {k: ([v[i] for i in index]
                          if isinstance(v, list) and len(v) == rows else v)
                      for k, v in (meta or {}).items()}
        yield batch, meta, take_rows(batch, index, rows), local_meta, rows


def _gather_rows(x, mesh, rows: int):
    """A per-row array of this rank's padded block -> the global rows in
    order (numpy), gathered over the data ranks."""
    from interactvlm_tpu_torch.parallel.collectives import all_gather_batch

    if x is None:
        return None
    t = torch.as_tensor(np.ascontiguousarray(x))
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if mesh.backend == "nccl" else torch.device("cpu")
    return all_gather_batch(t.to(dev), mesh.data_group).cpu().numpy()[:rows]


@torch.inference_mode()
def validate(batch_iter, model: InteractVLM, ds_name: str, mask_size: int,
             inference_type: str = "generate",
             human_maps: Optional[Dict] = None,
             object_maps: Optional[Dict] = None,
             dist_matrix: Optional[np.ndarray] = None,
             max_batches: Optional[int] = None, kv_cache: str = "dense",
             cache_view_encode: Optional[bool] = None,
             max_new_tokens: Optional[int] = None,
             max_seg_tokens: Optional[int] = None, mesh=None):
    """The eval loop (port of ``interactvlm_tpu/eval/evaluate.py:validate``,
    reference evaluate.py:41-248) over ``(batch, meta)`` pairs on the
    model's device. Returns (metrics dict, saved results for the DAMON
    reports): gIoU / cIoU, ``seg_rate`` (the share of rows that emitted a
    seg token; generate mode), and F1 / precision / recall / geodesic error
    for hcontact and ocontact, SIM / MAE / AUC / aIoU for oafford.

    ``inference_type`` "generate" decodes answers (``evaluate_batch``);
    "forward" runs the teacher-forced ``forward_train``. ``mesh``: the data
    ranks share each batch (``shard_eval_batches``): each runs its rows,
    the per-row predictions are gathered over ``data`` in row order, and
    every rank updates the meters from the whole batch as one process
    does, so every rank returns the one-process report.
    ``cache_view_encode``: encode the canonical view renders once and reuse
    the frozen-encoder embedding for every batch (valid when all samples
    share fixed renders -- hcontact's Vitruvian views). None: on for
    hcontact, off for per-sample-render object tasks.
    ``max_new_tokens``: generation budget per answer; None = 512 like the
    reference eval (evaluate.py:104). ``max_seg_tokens``: K seg-token slots
    decoded per answer; None = the model config's."""
    cfg = model.config
    dev = model.device
    if max_new_tokens is None:
        max_new_tokens = 512  # reference evaluate.py:104
    if max_seg_tokens is None:
        max_seg_tokens = int(getattr(cfg, "max_seg_tokens", 1) or 1)
    inter_m = AverageMeter("Intersec", summary_type=Summary.SUM)
    union_m = AverageMeter("Union", summary_type=Summary.SUM)
    giou_m = AverageMeter("gIoU")
    f1_m = AverageMeter("F1")
    prec_m = AverageMeter("Prec")
    rec_m = AverageMeter("Rec")
    geo_m = AverageMeter("Geo")
    seg_m = AverageMeter("SegRate")
    sim_m = AverageMeter("SIM")
    mae_m = AverageMeter("MAE")
    auc_m = AverageMeter("AUC")
    aiou_m = AverageMeter("aIoU")

    saved = {"imgnames": [], "pred": [], "gt": [], "f1": [], "geo": [],
             "objnames": []}

    is_h = "hcontact" in ds_name and "h2d" not in ds_name
    is_oa = "oafford" in ds_name
    is_oc = "ocontact" in ds_name
    # real-photo 2D segmentation: score in the ORIGINAL image frame
    # (reference validate scores postprocessed masks vs the label)
    is_2d = any(k in ds_name for k in
                ("h2dcontact", "refer_seg", "reason_seg", "sem_seg"))
    if cache_view_encode is None:
        cache_view_encode = is_h  # fixed canonical renders (see docstring)
    cached_emb = None
    split = mesh is not None and mesh.n_data > 1
    if split:
        batch_iter = shard_eval_batches(batch_iter, mesh)
    else:
        batch_iter = ((b, m, b, m, None) for b, m in batch_iter)

    def rows_of(x):
        return _gather_rows(x, mesh, rows) if split else x

    for bi, (batch, meta, local, local_meta, rows) in enumerate(batch_iter):
        if max_batches is not None and bi >= max_batches:
            break
        if cache_view_encode and cached_emb is None:
            # frozen encoder + identical per-sample renders => constant.
            # Encode one sample's V views and broadcast over every batch.
            cached_emb = model.encode_sam_images(
                _dev(batch["sam_images"][:1], dev).to(cfg.sam.dtype))
        if inference_type == "generate":
            out = evaluate_batch(
                model, local, mask_size, contact_type=ds_name,
                max_new_tokens=max_new_tokens, human_maps=human_maps,
                object_maps=object_maps, kv_cache=kv_cache,
                meta=local_meta if is_2d else None,
                cached_image_emb=cached_emb, max_seg_tokens=max_seg_tokens)
            pred_masks = rows_of(_numpy(out["pred_masks"]))
            pred_3d = rows_of(_host(out["pred_contact_3d"]))
            # fraction of rows that emitted a seg token: the first thing
            # to check when generate-mode metrics come back zero
            seg_m.update(float(np.mean(rows_of(_numpy(out["has_seg"])))))
            originals = out["pred_masks_original"]
            if split and originals is not None:
                from interactvlm_tpu_torch.parallel.collectives import (
                    host_gather,
                )

                originals = [m for part in host_gather(
                    [_numpy(m) for m in originals], mesh.data_group)
                    for m in part][:rows]
            if is_2d and originals is not None:
                for b, pm in enumerate(originals):
                    gt = np.asarray(meta["label_list"][b])
                    i, u, acc = M.segmentation_metrics(_numpy(pm)[None],
                                                       gt[None])
                    inter_m.update(i)
                    union_m.update(u)
                    giou_m.update(acc)
                continue
        else:
            fwd = model.forward_train(local)
            pred_masks = fwd["pred_masks"]
            pred_3d = None
            if is_h and human_maps is not None:
                pred_3d = lift_human(
                    pred_masks, _dev(human_maps["p2v"], dev),
                    _dev(human_maps["bary"], dev), cfg.num_human_vertices)
            elif is_oa and "obj_p2p" in local:
                pred_3d = lift_points_per_sample(
                    pred_masks, local, cfg.num_object_points, dev)
            elif is_oc and "obj_p2v" in local:
                pred_3d = lift_objects_per_sample(
                    pred_masks, local, local["gt_ocontact"].shape[1], dev)
            pred_masks = rows_of(_numpy(pred_masks))
            pred_3d = rows_of(_host(pred_3d))

        gt_masks = _numpy(batch["gt_masks"])
        if gt_masks.ndim == 5:
            # K-slot training batches (collate max_seg_tokens>1): score
            # the first-token pred against slot 0's GT
            gt_masks = gt_masks[:, 0]
        if pred_masks.ndim == 5:
            pred_masks = pred_masks[:, 0]
        for b in range(pred_masks.shape[0]):
            i, u, acc = M.segmentation_metrics(pred_masks[b], gt_masks[b])
            inter_m.update(i)
            union_m.update(u)
            giou_m.update(acc)

        if is_h and pred_3d is not None:
            gt3d = _numpy(batch["gt_hcontact"])
            f1, p, r = M.contact_f1(gt3d, pred_3d)
            f1_m.update(f1)
            prec_m.update(p)
            rec_m.update(r)
            if dist_matrix is not None:
                geo, _ = M.geodesic_contact_errors(pred_3d, gt3d, dist_matrix)
                geo_m.update(geo)
            for b in range(pred_3d.shape[0]):
                saved["imgnames"].append([meta["image_paths"][b]])
                saved["pred"].append(pred_3d[b] >= 0.5)
                saved["gt"].append(gt3d[b] > 0)
                saved["f1"].append(
                    M.contact_f1(gt3d[b:b + 1], pred_3d[b:b + 1])[0])
                # per-sample geodesic FP distance (reference stores it per
                # image for the DAMON reports, eval_utils.py:127-151)
                geo_b = 0.0
                if dist_matrix is not None:
                    geo_b, _ = M.geodesic_contact_errors(
                        pred_3d[b:b + 1], gt3d[b:b + 1], dist_matrix)
                saved["geo"].append(geo_b)
                saved["objnames"].append(
                    [[meta["sampled_classes_list"][b][0]
                      if meta["sampled_classes_list"][b] else "unknown"]])
        if is_oa and pred_3d is not None:
            gt3d = _numpy(batch["gt_oafford"])
            sim, mae, auc, aiou, _ = M.affordance_metrics(gt3d, pred_3d)
            sim_m.update(sim)
            mae_m.update(mae)
            auc_m.update(auc)
            aiou_m.update(aiou)
        if is_oc:
            if "gt_ocontact" not in batch:
                # never silently score object contact against human GT
                warnings.warn(
                    "ocontact batch lacks gt_ocontact; skipping F1 "
                    "(enable include_object_maps in collate)")
            elif pred_3d is not None:
                gt3d = _numpy(batch["gt_ocontact"])
                f1, p, r = M.contact_f1(gt3d, pred_3d)
                f1_m.update(f1)
                prec_m.update(p)
                rec_m.update(r)

    iou_class = np.asarray(inter_m.sum) / (np.asarray(union_m.sum) + 1e-10)
    results = {
        "giou": float(np.asarray(giou_m.avg).reshape(-1)[-1]),
        "ciou": float(iou_class.reshape(-1)[-1]),
    }
    if seg_m.count:
        results["seg_rate"] = float(seg_m.avg)
    if is_h or is_oc:
        results.update(
            f1=float(f1_m.avg), precision=float(prec_m.avg),
            recall=float(rec_m.avg), geo=float(geo_m.avg))
    if is_oa:
        results.update(
            sim=float(sim_m.avg), mae=float(mae_m.avg),
            auc=float(auc_m.avg), aiou=float(aiou_m.avg))
    return results, saved


def damon_binary_contact(saved: Dict, threshold: float = 0.5) -> Dict:
    """Image-wise union of per-object contacts -> binary F1
    (reference evaluate.py:427-468)."""
    imgwise = {}
    for i, name in enumerate(saved["imgnames"]):
        key = name[0]
        pred = np.asarray(saved["pred"][i]).astype(bool)
        gt = np.asarray(saved["gt"][i]).astype(bool)
        if key not in imgwise:
            imgwise[key] = {"pred": pred, "gt": gt, "geo": saved["geo"][i]}
        else:
            imgwise[key]["pred"] |= pred
            imgwise[key]["gt"] |= gt
            imgwise[key]["geo"] = max(imgwise[key]["geo"], saved["geo"][i])

    f1s, geos = [], []
    tp = pred_pos = gt_pos = 0
    for v in imgwise.values():
        tpi = np.sum(v["pred"] & v["gt"])
        ppi = np.sum(v["pred"])
        gpi = np.sum(v["gt"])
        prec = tpi / ppi if ppi else 0
        rec = tpi / gpi if gpi else 0
        f1s.append(2 * prec * rec / (prec + rec) if (prec + rec) else 0)
        geos.append(v["geo"])
        tp += tpi
        pred_pos += ppi
        gt_pos += gpi
    return {
        "f1": float(np.mean(f1s)) if f1s else 0.0,
        "precision": float(tp / pred_pos) if pred_pos else 0.0,
        "recall": float(tp / gt_pos) if gt_pos else 0.0,
        "geo": float(np.mean(geos)) if geos else 0.0,
        "num_images": len(imgwise),
    }


def damon_semantic_contact(saved: Dict) -> Dict:
    """Object-wise + category-wise semantic contact metrics
    (reference evaluate.py:355-424)."""
    objnames = [o[0][0].lower() for o in saved["objnames"]]
    by_obj: Dict[str, List[int]] = {}
    for i, obj in enumerate(objnames):
        by_obj.setdefault(obj, []).append(i)

    def group_stats(indices):
        preds = [saved["pred"][i] for i in indices]
        gts = [saved["gt"][i] for i in indices]
        tp = sum(np.sum(np.logical_and(p, g)) for p, g in zip(preds, gts))
        pp = sum(np.sum(p) for p in preds)
        gp = sum(np.sum(g) for g in gts)
        return {
            "num_samples": len(indices),
            "avg_f1": float(np.mean([saved["f1"][i] for i in indices])),
            "precision": float(tp / pp) if pp else 0.0,
            "recall": float(tp / gp) if gp else 0.0,
            "geo": float(np.mean([saved["geo"][i] for i in indices])),
        }

    semantic = {obj: group_stats(idx) for obj, idx in by_obj.items()}
    total = sum(r["num_samples"] for r in semantic.values())
    weighted_f1 = (
        sum(r["avg_f1"] * r["num_samples"] for r in semantic.values()) / total
        if total else 0.0
    )

    categories = {}
    for cat, objs in DAMON_CATEGORIES_MAPPING.items():
        idx = [i for i, o in enumerate(objnames) if o in objs]
        if idx:
            categories[cat] = group_stats(idx)

    return {
        "objectwise": semantic,
        "weighted_f1": weighted_f1,
        "categories": categories,
    }


@torch.no_grad()
def quantize_dequantize_llama_(model: InteractVLM, min_size: int = 2 ** 16):
    """``--quantize_weights``: every LLaMA linear weight of at least
    ``min_size`` elements rounded to int8 (one scale per output row) and
    back, in place (the JAX package's ``quantize_params_int8`` then
    ``dequantize_params`` over ``llava/lm``; the reference's bitsandbytes
    role, run_demo.py:106-129)."""
    from interactvlm_tpu_torch.ops.quant import dequantize_int8, quantize_int8

    for mod in model.llava.lm.modules():
        w = getattr(mod, "weight", None)
        if (isinstance(mod, torch.nn.Linear) and w is not None
                and w.dim() == 2 and w.numel() >= min_size):
            q, s = quantize_int8(w, axis=1)
            w.copy_(dequantize_int8(q, s, w.dtype))


def restore_run(run_dir: str, device):
    """A training run directory's model on ``device``: the training config
    re-hydrated from ``pretrained_config.json`` (reference
    eval_utils.py:215-244), with the seg-token ids persisted at train time,
    and the best (else the latest) checkpoint's weights. Returns (model,
    config, the training args, the config JSON)."""
    from interactvlm_tpu_torch.train.checkpoints import (
        CheckpointManager,
        load_config,
    )
    from interactvlm_tpu_torch.train.train import (
        build_model_and_config,
        parse_args,
    )

    cfg_json = load_config(run_dir, "pretrained_config.json")
    train_args = parse_args([])
    for k, v in cfg_json.items():
        if hasattr(train_args, k):
            setattr(train_args, k, v)
    # token registry persisted at train time (tokens precede the model build)
    token_kw = {
        k: cfg_json[k]
        for k in ("vocab_size", "seg_token_idx",
                  "hseg_token_idx", "oseg_token_idx")
        if k in cfg_json
    }
    model, cfg = build_model_and_config(train_args, device=device,
                                        **token_kw)
    ckpt = CheckpointManager(run_dir)
    state = ckpt.restore_best(map_location=device) or ckpt.restore(
        map_location=device)
    if state is None:
        raise FileNotFoundError(f"no checkpoint in {run_dir}")
    model.load_state_dict(state["model"])
    return model, cfg, train_args, cfg_json


def main(argv=None):
    """Eval CLI (reference ``evaluate.py main_eval``, :486-601): re-hydrate
    the training config from the run dir (eval_utils.py:215-244), restore
    the best (else the latest) checkpoint, run validation on the requested
    dataset, and emit the DAMON reports. Runs on the card unless
    ``--device cpu``.

        python -m interactvlm_tpu_torch.eval.evaluate --run_dir <run> \\
            --dataset_dir <tree> [--device cpu]
    """
    import argparse
    import json

    from interactvlm_tpu_torch.runtime.hostmem import tune_host_allocator
    from interactvlm_tpu_torch.utils.device import resolve_device

    p = argparse.ArgumentParser("interactvlm_tpu_torch evaluation")
    p.add_argument("--run_dir", required=True,
                   help="training run dir (config + checkpoints)")
    p.add_argument("--dataset_dir", default="./data")
    p.add_argument("--val_dataset", default="hcontact")
    p.add_argument("--inference_type", default="generate",
                   choices=["generate", "forward"])
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--kv_cache", default="dense", choices=["dense", "int8"],
                   help="KV-cache precision for the decode loop")
    p.add_argument("--quantize_weights", action="store_true",
                   help="round the large LLaMA weights to int8 and back "
                        "(the reference's bitsandbytes role, "
                        "run_demo.py:106-129)")
    p.add_argument("--geodesic_npy", default=None,
                   help="path to smpl_neutral_geodesic_dist.npy (6890^2 "
                        "geodesic matrix; reference eval_utils.py:15) -- "
                        "enables the geodesic FP/FN columns")
    p.add_argument("--distributed", action="store_true",
                   help="share each eval batch over the ranks of a "
                        "torchrun launch, one a card over NCCL (gloo with "
                        "--device cpu); the report is the one-process "
                        "report (reference DistributedSampler, "
                        "evaluate.py:346)")
    p.add_argument("--cache_view_encode", default="auto",
                   choices=["auto", "on", "off"],
                   help="encode the fixed canonical view renders once and "
                        "reuse the frozen-encoder embedding every batch "
                        "(auto: on for hcontact, off for per-sample-render "
                        "object tasks)")
    p.add_argument("--max_new_tokens", type=int, default=512,
                   help="generation budget per answer (reference "
                        "evaluate.py:104 uses 512)")
    p.add_argument("--max_seg_tokens", type=int, default=0,
                   help="seg-token mask sets decoded per answer; 0 = "
                        "auto from the re-hydrated token_type (2 for "
                        "Gen-Hu-Obj/Gen-Int)")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="where the model runs: the card unless 'cpu'")
    args = p.parse_args(argv)
    from interactvlm_tpu_torch.parallel.mesh import (
        Mesh,
        create_mesh,
        join_launch,
    )

    if args.distributed:
        dev = join_launch(args.device, "--distributed")
        mesh = create_mesh(n_model=1)
    else:
        dev, mesh = resolve_device(args.device), Mesh()
    tune_host_allocator()

    from interactvlm_tpu_torch.train.train import (
        _load_human_maps,
        make_tokenizer,
    )
    from interactvlm_tpu_torch.utils.testing import make_synthetic_batch

    model, cfg, train_args, cfg_json = restore_run(args.run_dir, dev)
    if args.quantize_weights:
        quantize_dequantize_llama_(model)

    if args.synthetic:
        example = make_synthetic_batch(cfg, B=args.batch_size,
                                       mask_size=train_args.mask_size,
                                       device=dev)

        def batches():
            for i in range(args.max_batches or 2):
                b = make_synthetic_batch(
                    cfg, B=args.batch_size, tasks=(2,),
                    mask_size=train_args.mask_size, seed=i, device=dev,
                )
                meta = {
                    "image_paths": [f"img{i}_{j}.jpg"
                                    for j in range(args.batch_size)],
                    "sampled_classes_list": [["chair"]] * args.batch_size,
                }
                yield b, meta
        human_maps = {
            "p2v": example["human_p2v"], "bary": example["human_bary"],
            "num_vertices": cfg.num_human_vertices,
        }
        mask_size = train_args.mask_size
    else:
        from interactvlm_tpu_torch.data.collate import collate
        from interactvlm_tpu_torch.data.datasets import (
            ValDataset,
            build_dataset,
        )
        from interactvlm_tpu_torch.runtime.prefetch import iter_sample_batches

        tokenizer, _ = make_tokenizer(train_args,
                                      cfg_json.get("tokenizer", "hf"),
                                      cfg_json.get("version"))
        # one construction path with train/validate: prompts, view types
        # and vertex counts come from the re-hydrated training config
        ds = ValDataset(
            build_dataset(args.val_dataset, args.dataset_dir, "test",
                          train_args)
        )
        mask_size = (
            train_args.image_size
            if train_args.image_size != 1024
            else ds.dataset.view_set.mask_size
        )
        human_maps = _load_human_maps(args.dataset_dir, dev)
        if human_maps is not None:
            human_maps = {
                **human_maps, "num_vertices": cfg.num_human_vertices,
            }

        def batches():
            for samples in iter_sample_batches(ds, args.batch_size):
                yield collate(samples, tokenizer,
                              max_len=train_args.model_max_length,
                              num_human_vertices=cfg.num_human_vertices,
                              num_object_points=cfg.num_object_points,
                              human_maps=human_maps,
                              include_object_maps=args.val_dataset in
                              ("oafford", "ocontact"))

    dist_matrix = None
    if args.geodesic_npy:
        dist_matrix = np.load(args.geodesic_npy)
        if dist_matrix.ndim != 2 or dist_matrix.shape[0] != \
                dist_matrix.shape[1]:
            raise ValueError(f"--geodesic_npy: a square matrix, not "
                             f"{dist_matrix.shape}")

    results, saved = validate(
        batches(), model, args.val_dataset, mask_size,
        inference_type=args.inference_type,
        human_maps=human_maps, max_batches=args.max_batches,
        kv_cache=args.kv_cache, dist_matrix=dist_matrix,
        cache_view_encode=(None if args.cache_view_encode == "auto"
                           else args.cache_view_encode == "on"),
        max_new_tokens=args.max_new_tokens,
        max_seg_tokens=args.max_seg_tokens or None, mesh=mesh,
    )
    report = {"metrics": results}
    if "hcontact" in args.val_dataset and saved["pred"]:
        report["damon_binary"] = damon_binary_contact(saved)
        report["damon_semantic"] = {
            "weighted_f1": damon_semantic_contact(saved)["weighted_f1"]
        }
    if mesh.is_main:
        print(json.dumps(report, indent=2, default=float))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=2, default=float)
    return report


if __name__ == "__main__":
    main()
    import torch.distributed as _dist

    if _dist.is_initialized():
        _dist.destroy_process_group()
