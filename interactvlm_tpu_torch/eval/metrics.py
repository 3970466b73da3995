"""Evaluation metrics: IoU, contact F1/P/R, geodesic error, affordance
SIM/MAE/AUC/aIoU (a copy of ``interactvlm_tpu/eval/metrics.py``).

Numpy rebuild of the reference metrics (``utils/eval_utils.py``), run
host-side on small arrays. AUC is computed directly via the Mann-Whitney
rank statistic (no sklearn dependency).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

IGNORE_LABEL = -1


def intersection_and_union(output, target, K: int = 2):
    """Per-class intersection/union histograms with IGNORE_LABEL masking
    (reference eval_utils.py:27-39)."""
    output = np.asarray(output).reshape(-1).copy()
    target = np.asarray(target).reshape(-1)
    output[target == IGNORE_LABEL] = IGNORE_LABEL
    inter = output[output == target]
    bins = np.arange(K + 1) - 0.5
    area_inter = np.histogram(inter, bins=bins)[0].astype(np.float64)
    area_out = np.histogram(output, bins=bins)[0].astype(np.float64)
    area_tgt = np.histogram(target, bins=bins)[0].astype(np.float64)
    return area_inter, area_out + area_tgt - area_inter, area_tgt


def segmentation_metrics(pred_masks, gt_masks):
    """Mean intersection/union/per-view-accumulated IoU over one sample's
    views (reference get_segmentation_metrics, eval_utils.py:41-61).

    pred_masks: (V, H, W) logits; gt_masks: (V, H, W) in {0,1,-1}.
    Returns (intersection, union, acc_iou) each shape (2,).
    """
    pred_bin = (np.asarray(pred_masks) > 0).astype(np.int64)
    gt = np.asarray(gt_masks).astype(np.int64)
    intersection = np.zeros(2)
    union = np.zeros(2)
    acc_iou = np.zeros(2)
    n = 0
    for p, g in zip(pred_bin, gt):
        i, u, _ = intersection_and_union(p, g, 2)
        intersection += i
        union += u
        iou = i / (u + 1e-5)
        iou[u == 0] += 1.0  # no-object target counts as perfect
        acc_iou += iou
        n += 1
    return intersection / n, union / n, acc_iou / n


def contact_f1(
    contact_gt, contact_pred, threshold: float = 0.5
) -> Tuple[float, float, float]:
    """Batch-averaged F1/precision/recall at a probability threshold
    (reference get_h_contact_metrics / get_o_contact_metrics,
    eval_utils.py:63-125)."""
    gt = np.asarray(contact_gt, dtype=np.float64)
    pred = np.asarray(contact_pred, dtype=np.float64)
    f1s, ps, rs = [], [], []
    for g, p in zip(gt, pred):
        pb = (p >= threshold).astype(np.float64)
        gb = (g > 0).astype(np.float64)
        tp = (pb * gb).sum()
        prec = tp / (pb.sum() + 1e-10)
        rec = tp / (gb.sum() + 1e-10)
        f1 = 2 * prec * rec / (prec + rec + 1e-10)
        f1s.append(f1)
        ps.append(prec)
        rs.append(rec)
    return float(np.mean(f1s)), float(np.mean(ps)), float(np.mean(rs))


def geodesic_contact_errors(
    pred, gt, dist_matrix, threshold: float = 0.5
) -> Tuple[float, float]:
    """False-positive / false-negative geodesic distances on the body
    surface via the precomputed NxN geodesic matrix
    (reference get_h_geo_metric, eval_utils.py:127-151)."""
    pred = np.asarray(pred)
    gt = np.asarray(gt)
    fp_list, fn_list = [], []
    for b in range(gt.shape[0]):
        gt_cols = (
            dist_matrix[:, gt[b] == 1] if (gt[b] == 1).any() else dist_matrix
        )
        err = (
            gt_cols[pred[b] >= threshold, :]
            if (pred[b] >= threshold).any()
            else gt_cols
        )
        fp_list.append(err.min(axis=1).mean())
        fn_list.append(err.min(axis=0).mean())
    return float(np.mean(fp_list)), float(np.mean(fn_list))


def similarity(map1, map2, eps: float = 1e-12) -> float:
    """Histogram intersection similarity (reference SIM,
    eval_utils.py:22-25)."""
    m1 = np.asarray(map1, dtype=np.float64)
    m2 = np.asarray(map2, dtype=np.float64)
    m1 = m1 / (m1.sum() + eps)
    m2 = m2 / (m2.sum() + eps)
    return float(np.minimum(m1, m2).sum())


def auc_score(labels, scores) -> float:
    """Binary ROC-AUC via the rank (Mann-Whitney U) statistic; matches
    sklearn.roc_auc_score on untied and tied inputs."""
    labels = np.asarray(labels).astype(bool).reshape(-1)
    scores = np.asarray(scores, dtype=np.float64).reshape(-1)
    n_pos = labels.sum()
    n_neg = (~labels).sum()
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(scores)
    sorted_scores = scores[order]
    # average ranks for ties
    i = 0
    r = np.arange(1, len(scores) + 1, dtype=np.float64)
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        r[i : j + 1] = (i + j + 2) / 2.0
        i = j + 1
    ranks[order] = r
    u = ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def affordance_metrics(
    contact_gt, contact_pred, num_points: int = 2048
):
    """SIM / MAE / AUC / aIoU averages over a batch (reference
    get_o_affordance_metrics, eval_utils.py:153-213). Samples whose binary
    GT is single-class are excluded from AUC/aIoU like the reference."""
    gt = np.asarray(contact_gt, dtype=np.float64)
    pred = np.asarray(contact_pred, dtype=np.float64)
    B = gt.shape[0]
    thresholds = np.linspace(0, 1, 20)

    sim_total = mae_total = auc_total = iou_total = 0.0
    valid = B
    for b in range(B):
        sim_total += similarity(gt[b], pred[b])
        mae_total += np.abs(gt[b] - pred[b]).sum() / num_points
        gt_bin = (gt[b] >= 0.5).astype(np.int64)
        if len(np.unique(gt_bin)) == 1:
            valid -= 1
            continue
        auc_total += auc_score(gt_bin, pred[b])
        ious = []
        for t in thresholds:
            pb = (pred[b] >= t).astype(np.int64)
            inter = (pb & gt_bin).sum()
            union = (pb | gt_bin).sum()
            ious.append(inter / union if union > 0 else 0.0)
        iou_total += float(np.mean(ious))

    return (
        sim_total / B,
        mae_total / B,
        auc_total / max(1, valid),
        iou_total / max(1, valid),
        valid,
    )
