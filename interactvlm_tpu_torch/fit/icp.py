"""ICP on 6-D position + normal point clouds.

Port of ``interactvlm_tpu/fit/icp.py`` (the reference's PyTorch3D-adapted
ICP, ``optim/icp/icp.py:38-266``): nearest neighbours by a brute-force
expanded-norm distance matrix and argmin, the Umeyama alignment
(``corresponding_points_alignment``, icp.py:274-420) by the SVD of the
3 x 3 covariance, and the relative-change convergence test. The JAX
package runs a fixed-length scan whose state freezes once converged; the
port leaves the loop there, with the same state. Each iteration reads
``done`` on the host (and on the card the 3 x 3 SVD synchronises too).

Matching the reference:
- the neighbours are found on [position (+) normal] 6-D points, with the
  HUMAN normals negated (icp.py:178-187) so that opposing surfaces
  attract;
- the alignment itself uses only the 3-D positions;
- the convergence metric is the positional rmse plus a (1 - cos) normal
  term and an optional below-min-scale penalty (icp.py:218-240).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from interactvlm_tpu_torch.fit.utils import _floor


class SimilarityTransform(NamedTuple):
    R: torch.Tensor  # (3, 3)
    T: torch.Tensor  # (3,)
    s: torch.Tensor  # ()


class ICPSolution(NamedTuple):
    converged: torch.Tensor
    rmse: torch.Tensor
    Xt: torch.Tensor
    RTs: SimilarityTransform


def apply_similarity_transform(X, R, T, s):
    """``s * X @ R + T`` (row vectors, as the reference's
    ``_apply_similarity_transform``)."""
    return s * (X @ R) + T


def corresponding_points_alignment(X, Y, weights=None,
                                   estimate_scale: bool = False,
                                   allow_reflection: bool = False,
                                   eps: float = 1e-9) -> SimilarityTransform:
    """Umeyama: (R, T, s) with ``s X R + T ~= Y`` (reference
    icp.py:274-420). X, Y: (P, 3); weights: (P,) or None. With all weights
    0 the total is ``eps``: the means and the covariance are 0."""
    w = (torch.ones(X.shape[0], dtype=X.dtype, device=X.device)
         if weights is None else weights.to(X.dtype))
    total = _floor(w.sum(), eps)
    Xmu = (X * w[:, None]).sum(0) / total
    Ymu = (Y * w[:, None]).sum(0) / total
    Xc, Yc = X - Xmu, Y - Ymu
    XYcov = (Xc * w[:, None]).T @ Yc / total  # (3, 3)
    U, S, Vt = torch.linalg.svd(XYcov)
    V = Vt.T
    e = torch.ones(3, dtype=X.dtype, device=X.device)
    if not allow_reflection:
        e = torch.cat([e[:2], torch.sign(torch.linalg.det(U)
                                         * torch.linalg.det(V))[None]])
    R = U @ torch.diag(e) @ V.T
    if estimate_scale:
        Xcov = (Xc * Xc * w[:, None]).sum() / total
        s = (e * S).sum() / _floor(Xcov, eps)
    else:
        s = torch.ones((), dtype=X.dtype, device=X.device)
    return SimilarityTransform(R, Ymu - s * (Xmu @ R), s)


def nearest_neighbors(query, ref):
    """Brute-force 1-NN indices: (Pq, d), (Pr, d) -> (Pq,) int32, the
    first index among equal distances. The expanded-norm form keeps the
    (Pq, Pr) matrix in one matrix product."""
    d2 = ((query ** 2).sum(-1, keepdim=True) - 2.0 * query @ ref.T
          + (ref ** 2).sum(-1)[None, :])
    return torch.argmin(d2, dim=1).to(torch.int32)


def icp(obj_points, hum_points, obj_normals: Optional[torch.Tensor] = None,
        hum_normals: Optional[torch.Tensor] = None,
        init_transform: Optional[SimilarityTransform] = None,
        max_iterations: int = 100, relative_rmse_thr: float = 1e-6,
        estimate_scale: bool = False, allow_reflection: bool = False,
        min_scale: Optional[float] = None, scale_penalty: float = 10.0,
        obj_weights: Optional[torch.Tensor] = None) -> ICPSolution:
    """Single-sample ICP on the points' device. ``obj_weights``: optional
    (Po,) weights (0 excludes a point from the alignment and the
    metric)."""
    X0, Yh = obj_points.float(), hum_points.float()
    if init_transform is not None:
        R, T, s = init_transform
        Xt = apply_similarity_transform(X0, R, T, s)
    else:
        R = torch.eye(3, device=X0.device)
        T = torch.zeros(3, device=X0.device)
        s = torch.ones((), device=X0.device)
        Xt = X0
    use_normals = obj_normals is not None and hum_normals is not None
    if use_normals:
        obj_normals = obj_normals.float()
        hum_comb = torch.cat([Yh, -hum_normals.float()], -1)
    else:
        hum_comb = Yh
    if obj_weights is not None:
        wsum = _floor(obj_weights.sum(), 1e-8)

    def weighted_mean(x):
        return (x.mean() if obj_weights is None
                else (x * obj_weights).sum() / wsum)

    prev = torch.tensor(-1.0, device=X0.device)
    done = torch.tensor(False, device=X0.device)
    for _ in range(max_iterations):
        obj_comb = torch.cat([Xt, obj_normals], -1) if use_normals else Xt
        nn = nearest_neighbors(obj_comb, hum_comb).long()
        nn_pts = Yh[nn]
        R, T, s = corresponding_points_alignment(
            X0, nn_pts, weights=obj_weights, estimate_scale=estimate_scale,
            allow_reflection=allow_reflection)
        Xt = apply_similarity_transform(X0, R, T, s)
        combined = torch.sqrt(weighted_mean(((Xt - nn_pts) ** 2).sum(-1)))
        if use_normals:
            # rotated object normals against the (inward) neighbour normals
            cos = ((obj_normals @ R) * hum_comb[nn][:, 3:]).sum(-1)
            combined = combined + weighted_mean(1 - cos)
        if min_scale is not None:
            combined = combined + scale_penalty * torch.maximum(
                s - min_scale, s.new_zeros(()))
        rel = torch.where(prev > 0, (combined - prev) / prev, 1.0)
        done = rel.abs() <= relative_rmse_thr
        prev = combined
        if done:
            break
    return ICPSolution(done, prev, Xt, SimilarityTransform(R, T, s))
