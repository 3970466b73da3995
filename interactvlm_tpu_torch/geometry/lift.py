"""2D -> 3D contact lifting.

Port of ``interactvlm_tpu/geometry/lift.py``. The soft barycentric lift for
the fixed-topology human mesh (reference ``HumanContact3DPredictor``,
components.py:220-277): per view,
``sigmoid(clamp(logits, -20, 20))`` is scattered with barycentric weights
onto vertices and normalised by the scattered weight; views are then
averaged per vertex over the views that saw it; the result is clamped to
[0, 1]. The scatter form (``index_add_``) serves ``lift_human``; the gather
form (per-vertex pixel lists from ``build_gather_maps``) is numerically the
same whenever no vertex has more than ``max_k`` candidates.

The per-sample object lifts take one sample's maps: the thresholded
barycentric lift onto an object mesh (reference
``ObjectMeshContact3DPredictor``, components.py:445-489) and the point-cloud
lift through a pixel -> point map (``ObjectPCAfford3DPredictor``,
components.py:318-347).

The batched lifts of the training losses (``lift_batch_soft``,
``lift_batch_thresholded``, ``lift_batch_points``) fold the batch into the
segment ids of one ``index_add`` and are differentiable in the logits.
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


def clip(x, lo: float, hi: float):
    """``jnp.clip``: a maximum, then a minimum, so that a value on a bound
    takes half the gradient, as in JAX (``torch.clamp`` passes all of it)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


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


def lift_multiview_thresholded(logits, p2v3, bary3, num_vertices: int,
                               threshold: float = 0.3):
    """Thresholded lift onto an object mesh: logits (V, H, W), corner-major
    maps (3, V, H, W). Pixels whose probability exceeds ``threshold``
    scatter it with barycentric weights; each view is normalised by its
    scattered weight, then views are averaged over those that saw the
    vertex. The selection carries no gradient. Returns (num_vertices,)."""
    V = logits.shape[0]
    probs = torch.sigmoid(logits.float())
    sel = (probs > threshold).float().detach()
    ids, weights = _flat_ids_and_weights(p2v3, bary3.float(), V, num_vertices,
                                         sel)
    values = probs[None].expand(p2v3.shape).reshape(-1)
    out, _ = _per_view_normalized_scatter(values, weights, ids, V,
                                          num_vertices)
    return out


def lift_multiview_points(values, p2p, num_points: int):
    """Point-cloud lift: per-pixel values (V, H, W) are averaged per point
    and view through the pixel -> point map p2p (V, H, W) (-1 invalid),
    then over the views in which the point is visible. Returns
    (num_points,)."""
    V = values.shape[0]
    valid = (p2p >= 0) & (p2p < num_points)
    view = torch.arange(V, device=p2p.device).view(V, 1, 1)
    ids = torch.where(valid, view * num_points + p2p.clamp(0, num_points - 1),
                      V * num_points).reshape(-1).long()
    out, _ = _per_view_normalized_scatter(
        values.float().reshape(-1), valid.float().reshape(-1), ids, V,
        num_points)
    return out


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


def _flat_ids_and_weights(p2v3, bary3, num_views: int, num_vertices: int,
                          select):
    """Corner-major (3, V, H, W) maps -> flat candidate ids (segment
    ``view * N + vertex``, dump ``V * N``) and weights; ``select`` (V, H, W)
    multiplies the weights (validity and threshold selection)."""
    valid = ((p2v3 >= 0) & (p2v3 < num_vertices)).all(dim=0)
    sel = valid.to(bary3.dtype) * select
    view = torch.arange(num_views, device=p2v3.device).view(1, -1, 1, 1)
    ids = torch.where((valid & (select > 0))[None],
                      view * num_vertices + p2v3.clamp(0, num_vertices - 1),
                      num_views * num_vertices)
    return ids.reshape(-1).long(), (bary3 * sel[None]).reshape(-1)


def _batched_normalized_scatter(values, weights, ids, B: int, num_views: int,
                                num_vertices: int):
    """(B, K) candidate streams with per-sample ids (dump ``V * N``) -> one
    ``index_add`` over ``B * V * N`` segments, normalised per view, then
    averaged over the views that saw each vertex. Returns (B, N)."""
    VN = num_views * num_vertices
    base = torch.arange(B, device=ids.device)[:, None] * VN
    bids = torch.where(ids == VN, B * VN, ids + base).reshape(-1)
    zeros = torch.zeros(B * VN + 1, dtype=values.dtype, device=values.device)
    votes = zeros.index_add(0, bids, (weights * values).reshape(-1))[:-1]
    wsum = zeros.index_add(0, bids, weights.reshape(-1))[:-1]
    votes = votes.reshape(B, num_views, num_vertices)
    wsum = wsum.reshape(B, num_views, num_vertices)
    seen = wsum > 0
    view_vote = torch.where(seen, votes / torch.where(seen, wsum, 1.0), 0.0)
    count = seen.sum(1).to(votes.dtype)
    total = view_vote.sum(1)
    return torch.where(count > 0, total / torch.where(count > 0, count, 1.0),
                       0.0)


def lift_batch_soft(logits, p2v3, bary3, num_vertices: int, active=None):
    """Batched soft lift: (B, V, H, W) logits and corner-major maps shared
    by the batch -> (B, N); ``active`` (B,) zeroes other samples."""
    B, V = logits.shape[:2]
    probs = torch.sigmoid(clip(logits.float(), -20.0, 20.0))
    ids, weights = _flat_ids_and_weights(
        p2v3, bary3.float(), V, num_vertices,
        torch.ones(logits.shape[1:], device=logits.device))
    values = probs[:, None].expand((B, 3) + probs.shape[1:]).reshape(B, -1)
    out = _batched_normalized_scatter(
        values, weights[None].expand(values.shape),
        ids[None].expand(values.shape), B, V, num_vertices)
    out = clip(out, 0.0, 1.0)
    if active is not None:
        out = torch.where(active[:, None], out, 0.0)
    return out


def lift_batch_thresholded(logits, p2v3, bary3, num_vertices: int,
                           threshold: float = 0.3):
    """Batched thresholded lift with per-sample corner-major maps
    (3, B, V, H, W) -> (B, N): pixels with probability above ``threshold``
    scatter it; the selection carries no gradient."""
    B, V = logits.shape[:2]
    probs = torch.sigmoid(logits.float())
    sel = (probs > threshold).float().detach()
    flat = [_flat_ids_and_weights(p2v3[:, b], bary3[:, b].float(), V,
                                  num_vertices, sel[b]) for b in range(B)]
    ids = torch.stack([f[0] for f in flat])
    weights = torch.stack([f[1] for f in flat])
    values = probs[:, None].expand((B, 3) + probs.shape[1:]).reshape(B, -1)
    return _batched_normalized_scatter(values, weights, ids, B, V,
                                       num_vertices)


def lift_batch_points(values, p2p, num_points: int):
    """Batched point-cloud lift: (B, V, H, W) values and per-sample maps
    (B, V, H, W) (-1 invalid) -> (B, P)."""
    B, V = values.shape[:2]
    valid = (p2p >= 0) & (p2p < num_points)
    view = torch.arange(V, device=p2p.device).view(1, V, 1, 1)
    ids = torch.where(valid, view * num_points + p2p.clamp(0, num_points - 1),
                      V * num_points).reshape(B, -1).long()
    return _batched_normalized_scatter(
        values.float().reshape(B, -1), valid.float().reshape(B, -1), ids, B,
        V, num_points)
