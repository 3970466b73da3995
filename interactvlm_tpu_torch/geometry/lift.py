"""2D -> 3D contact lifting for the fixed-topology human mesh.

Port of the soft barycentric lift of ``interactvlm_tpu/geometry/lift.py``
(reference ``HumanContact3DPredictor``, components.py:220-277): per view,
``sigmoid(clamp(logits, -20, 20))`` is scattered with barycentric weights
onto vertices and normalised by the scattered weight; views are then
averaged per vertex over the views that saw it; the result is clamped to
[0, 1]. The scatter form (``index_add_``) serves ``lift_human``; the gather
form (per-vertex pixel lists from ``build_gather_maps``) is numerically the
same whenever no vertex has more than ``max_k`` candidates.
"""

from __future__ import annotations

import numpy as np
import torch


def corner_major(arr):
    """Move a trailing barycentric-corner axis to the front:
    (..., H, W, 3) -> (3, ..., H, W)."""
    if isinstance(arr, np.ndarray):
        return np.ascontiguousarray(np.moveaxis(arr, -1, 0))
    return torch.movedim(arr, -1, 0).contiguous()


def _per_view_normalized_scatter(values, weights, ids, num_views,
                                 num_vertices):
    """Scatter ``weights * values`` and ``weights`` onto ``V * N`` segments
    (plus a dump slot ``V * N`` for invalid candidates), normalise per
    view, then average over the views in which each vertex got weight.

    Returns ((N,) lifted values, (N,) per-vertex view count).
    """
    n_seg = num_views * num_vertices + 1
    zeros = torch.zeros(n_seg, dtype=values.dtype, device=values.device)
    votes = zeros.index_add(0, ids, weights * values)[:-1]
    wsum = zeros.index_add(0, ids, weights)[:-1]
    votes = votes.reshape(num_views, num_vertices)
    wsum = wsum.reshape(num_views, num_vertices)
    seen = wsum > 0
    view_vote = torch.where(seen, votes / torch.where(seen, wsum, 1.0), 0.0)
    view_count = seen.sum(0).to(votes.dtype)
    total = view_vote.sum(0)
    out = torch.where(view_count > 0,
                      total / torch.where(view_count > 0, view_count, 1.0),
                      0.0)
    return out, view_count


def lift_multiview_soft(logits, p2v3, bary3, num_vertices: int):
    """Soft multi-view lift. logits (V, H, W); p2v3 (3, V, H, W) int
    corner-major pixel -> vertex map (-1 invalid); bary3 (3, V, H, W).
    Returns (num_vertices,) contact probabilities in [0, 1]."""
    V = logits.shape[0]
    probs = torch.sigmoid(logits.float().clamp(-20.0, 20.0))
    valid = ((p2v3 >= 0) & (p2v3 < num_vertices)).all(dim=0)  # (V, H, W)
    view = torch.arange(V, device=p2v3.device).view(1, V, 1, 1)
    ids = torch.where(valid[None],
                      view * num_vertices + p2v3.clamp(0, num_vertices - 1),
                      V * num_vertices)
    weights = bary3.float() * valid[None].float()
    values = probs[None].expand(p2v3.shape)
    out, _ = _per_view_normalized_scatter(
        values.reshape(-1), weights.reshape(-1), ids.reshape(-1).long(), V,
        num_vertices)
    return out.clamp(0.0, 1.0)


def build_gather_maps(p2v, bary, num_vertices: int, max_k: int = None):
    """Invert fixed pixel -> vertex maps into per-vertex gather lists, on
    the host with numpy, once per view set.

    p2v: (V, H, W, 3) int, bary: (V, H, W, 3). Returns (idx (V, N, K) int32
    into the flattened H*W view image, w (V, N, K) float32, zero at padding).
    """
    p2v = np.asarray(p2v)
    bary = np.asarray(bary)
    V = p2v.shape[0]
    HW = p2v.shape[1] * p2v.shape[2]
    flat_v = p2v.reshape(V, HW, 3)
    flat_w = bary.reshape(V, HW, 3)
    valid = (flat_v >= 0).all(-1) & (flat_v < num_vertices).all(-1)

    per_view = []
    k_needed = 1
    for v in range(V):
        pix = np.nonzero(valid[v])[0]
        verts = flat_v[v, pix].reshape(-1)
        pixels = np.repeat(pix, 3)
        weights = flat_w[v, pix].reshape(-1)
        order = np.argsort(verts, kind="stable")
        sv, sp, sw = verts[order], pixels[order], weights[order]
        group_start = np.searchsorted(sv, np.arange(num_vertices))
        rank = np.arange(sv.size) - group_start[sv]
        per_view.append((sv, sp, sw, rank))
        if sv.size:
            k_needed = max(k_needed, int(rank.max()) + 1)
    k = k_needed if max_k is None else max_k

    idx = np.zeros((V, num_vertices, k), np.int32)
    w = np.zeros((V, num_vertices, k), np.float32)
    for v, (sv, sp, sw, rank) in enumerate(per_view):
        keep = rank < k
        idx[v, sv[keep], rank[keep]] = sp[keep]
        w[v, sv[keep], rank[keep]] = sw[keep]
    return idx, w


def lift_multiview_soft_gather(logits, gather_idx, gather_w):
    """Gather-form soft lift: logits (V, H, W), gather_idx/w (V, N, K) from
    ``build_gather_maps``. Returns (N,)."""
    V = logits.shape[0]
    N, K = gather_idx.shape[1:]
    probs = torch.sigmoid(logits.float().clamp(-20.0, 20.0)).reshape(V, -1)
    vals = torch.gather(probs, 1, gather_idx.reshape(V, N * K).long())
    votes = (vals.reshape(V, N, K) * gather_w).sum(-1)
    wsum = gather_w.sum(-1)
    seen = wsum > 0
    view_vote = torch.where(seen, votes / torch.where(seen, wsum, 1.0), 0.0)
    count = seen.sum(0).float()
    total = view_vote.sum(0)
    out = torch.where(count > 0, total / torch.where(count > 0, count, 1.0),
                      0.0)
    return out.clamp(0.0, 1.0)
