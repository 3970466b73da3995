"""InteractVLM training losses as batched, masked tensor math.

Port of ``interactvlm_tpu/models/losses.py`` (reference ``model/losses.py``:
CombinedLoss and the three 3D losses). Every sample computes every loss and
task indicators select what counts; IGNORE_LABEL (-1) pixels are masked
everywhere. ``pred`` mask tensors are (B, V, H, W) logits, except for
heatmap (oafford) rows, whose prediction the model has already passed
through a sigmoid (``is_prob``). Clips follow ``jnp.clip`` (``lift.clip``),
so gradients at a bound agree with the JAX package's.

Every sum over the batch's rows goes through ``batch_sum`` (and every
``any`` over rows through ``batch_any``): the identity on one rank, and
where data ranks split a batch (``parallel/collectives.py:batch_group``) a
sum over their rows, so each rank's loss is the global batch's, as the JAX
package computes it on its mesh.
"""

from __future__ import annotations

import torch

from interactvlm_tpu_torch.geometry.lift import (
    clip,
    lift_batch_points,
    lift_batch_soft,
    lift_batch_thresholded,
)
from interactvlm_tpu_torch.parallel.collectives import (
    batch_any,
    batch_count,
    batch_sum,
)

IGNORE_LABEL = -1.0


def _safe_mean(x, w, dim=None):
    """sum(x * w) / sum(w), 0 where there is no weight; over every element
    of the global batch where ``dim`` is None."""
    num = batch_sum((x * w).sum()) if dim is None else (x * w).sum(dim)
    den = batch_sum(w.sum()) if dim is None else w.sum(dim)
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def _bce_with_logits(logits, targets):
    return (torch.maximum(logits, logits.new_zeros(())) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def _bce_probs(probs, targets, eps=1e-6):
    # eps must be f32-representable: 1 - 1e-12 rounds to 1.0 in f32
    p = clip(probs, eps, 1 - eps)
    return -(targets * torch.log(p) + (1 - targets) * torch.log1p(-p))


def focal_mask_loss(pred, gt, is_prob, alpha: float = 0.5,
                    gamma: float = 2.0):
    """Per-sample focal BCE (reference losses.py:116-152). pred/gt
    (B, V, H, W); ``is_prob`` (B,) rows use plain BCE on probabilities.
    Returns (B,)."""
    valid = (gt != IGNORE_LABEL).float()
    gt_safe = torch.where(valid > 0, gt, 0.0)
    pred_f = pred.float()
    is_prob_b = is_prob[:, None, None, None]
    bce_logit = _bce_with_logits(pred_f, gt_safe)
    # logit rows feed a safe 0.5 into the probability branch: a raw logit
    # clipped at 1 - eps would turn the where's zero cotangent into NaN
    bce_prob = _bce_probs(torch.where(is_prob_b, pred_f, 0.5), gt_safe)
    bce = torch.where(is_prob_b, bce_prob, bce_logit)
    focal = alpha * (1 - torch.exp(-bce)) ** gamma * bce
    return _safe_mean(focal, valid, dim=(2, 3)).mean(1)


def dice_mask_loss(pred, gt, is_prob, scale: float = 1.0, eps: float = 1e-5):
    """Per-sample dice with IGNORE masking and empty targets zeroed
    (reference losses.py:155-197). Returns (B,)."""
    pred_f = pred.float()
    probs = torch.where(is_prob[:, None, None, None], pred_f,
                        torch.sigmoid(pred_f))
    valid = (gt != IGNORE_LABEL).float()
    t = torch.where(valid > 0, gt, 0.0) * valid
    p = probs * valid / scale
    numerator = 2 * (p * t).sum((2, 3))
    denominator = p.sum((2, 3)) + (t / scale).sum((2, 3))
    loss = 1 - (numerator + eps) / (denominator + eps)
    nonempty = (t.sum((2, 3)) > 0) & (valid.sum((2, 3)) > 0)
    return torch.where(nonempty, loss, 0.0).mean(1)


def mse_mask_loss(pred, gt):
    """Per-sample masked MSE for heatmap rows (reference losses.py:92-113).
    Returns (B,)."""
    valid = (gt != IGNORE_LABEL).float()
    se = (pred.float() - torch.where(valid > 0, gt, 0.0)) ** 2
    return _safe_mean(se, valid, dim=(2, 3)).mean(1)


def _elementwise_focal(probs, targets, alpha, gamma):
    p = clip(probs, 1e-6, 1 - 1e-6)
    bce = _bce_probs(p, targets)
    return alpha * (1 - torch.exp(-bce)) ** gamma * bce


def human_contact_3d_loss(pred_masks, gt_contact, p2v3, bary3, is_h,
                          num_vertices: int, alpha: float = 0.25,
                          gamma: float = 2.0, sparsity_weight: float = 0.01):
    """Focal BCE on the soft multi-view lift plus sparsity (reference
    losses.py:203-234); corner-major (3, V, H, W) maps. Returns a scalar."""
    lifted = lift_batch_soft(pred_masks, p2v3, bary3, num_vertices)
    focal = _elementwise_focal(lifted, gt_contact, alpha, gamma)
    w = is_h.float()[:, None].expand(focal.shape)
    focal_mean = _safe_mean(focal, w)
    sparsity = _safe_mean(clip(lifted, 1e-6, 1 - 1e-6), w)
    return torch.where(batch_any(is_h),
                       focal_mean + sparsity_weight * sparsity, 0.0)


def object_contact_3d_loss(pred_masks, gt_contact, p2v3, bary3, valid_verts,
                           is_oc, alpha: float = 0.25, gamma: float = 2.0,
                           sparsity_weight: float = 0.01,
                           threshold: float = 0.3):
    """Per-sample focal BCE on the thresholded object-mesh lift (reference
    losses.py:236-281); per-sample corner-major maps (3, B, V, H, W),
    ``valid_verts`` (B, Nmax) masks each sample's vertices."""
    lifted = lift_batch_thresholded(pred_masks, p2v3, bary3,
                                    gt_contact.shape[1], threshold)
    vv = valid_verts.float()
    # the reference skips samples with empty predictions
    nonempty = (lifted * vv).sum(1) > 0
    w_sample = is_oc.float() * nonempty.float()
    focal = _elementwise_focal(lifted, gt_contact, alpha, gamma)
    per_sample = _safe_mean(focal, vv, dim=1) + sparsity_weight * _safe_mean(
        clip(lifted, 1e-6, 1 - 1e-6), vv, dim=1)
    return _safe_mean(per_sample, w_sample)


def object_afford_3d_loss(pred_values, gt_afford, p2p, is_oa,
                          alpha: float = 0.25, gamma: float = 2.0):
    """IAGNet-style affordance loss on the point-cloud lift (reference
    losses.py:284-341): focal CE * 0.5 + dual dice * 0.3 + 0.8 MSE + 0.4 L1."""
    lifted = lift_batch_points(pred_values, p2p, gt_afford.shape[1])
    p = clip(lifted, 1e-6, 1 - 1e-6)
    w = is_oa.float()
    wb = w[:, None].expand(p.shape)
    t1 = -(1 - alpha) * p ** gamma * (1 - gt_afford) * torch.log(1 - p)
    t2 = -alpha * (1 - p) ** gamma * gt_afford * torch.log(p)
    ce = _safe_mean(t1 + t2, wb)
    dice_pos = ((p * gt_afford).sum(1) + 1e-6) / (
        (p.abs() + gt_afford.abs()).sum(1) + 1e-6)
    dice_neg = (((1 - p) * (1 - gt_afford)).sum(1) + 1e-6) / (
        (2 - p.abs() - gt_afford.abs()).sum(1) + 1e-6)
    dice = _safe_mean(1.5 - dice_pos - dice_neg, w)
    mse = _safe_mean((p - gt_afford) ** 2, wb) * 0.8
    l1 = _safe_mean((p - gt_afford).abs(), wb) * 0.4
    return torch.where(batch_any(is_oa), ce * 0.5 + dice * 0.3 + mse + l1,
                       0.0)


def combined_mask_losses(pred_masks, gt_masks, is_heatmap, has_mask,
                         bce_loss_weight: float = 2.0,
                         bce_loss_alpha: float = 0.5,
                         dice_loss_weight: float = 1.0,
                         dice_loss_scale: float = 1.0, n_rows: int = 0):
    """2D mask losses over the batch (reference losses.py:42-72). Every row
    counts in the binary-mask denominator (the reference's
    num_binary_masks); ``n_rows`` overrides it. Returns (bce, dice, l2)."""
    focal = focal_mask_loss(pred_masks, gt_masks, is_heatmap, bce_loss_alpha)
    dice = dice_mask_loss(pred_masks, gt_masks, is_heatmap, dice_loss_scale)
    mse = mse_mask_loss(pred_masks, gt_masks)
    hm = is_heatmap.float()
    has = has_mask.float()
    n_binary = batch_count(float(n_rows or pred_masks.shape[0]), hm)
    n_heat = batch_sum(hm.sum())
    mask_bce = bce_loss_weight * batch_sum((focal * has).sum()) / n_binary
    mask_dice = dice_loss_weight * batch_sum((dice * has).sum()) / n_binary
    mask_l2 = bce_loss_weight * torch.where(
        n_heat > 0, batch_sum((mse * hm).sum()) / n_heat.clamp_min(1e-8), 0.0)
    return mask_bce, mask_dice, mask_l2
