"""Rotation, transform and mesh helpers of the joint human-object fit.

Port of ``interactvlm_tpu/fit/utils.py`` (reference ``optim/utils.py:22-62``
and ``render_mesh_utils.py:75-93``). Every function runs on its inputs'
device. The floors are ``torch.maximum`` against a tensor, which, like
``jnp.maximum``, passes half the gradient to each side of a tie
(``torch.clamp_min`` passes all of it).
"""

from __future__ import annotations

import torch


def _floor(x, eps: float):
    return torch.maximum(x, x.new_tensor(eps))


def _unit(x, eps: float = 1e-8):
    return x / _floor(torch.linalg.norm(x, dim=-1, keepdim=True), eps)


def rot6d_to_matrix(r6: torch.Tensor) -> torch.Tensor:
    """Continuous 6-D rotation parametrization -> 3x3 rotation matrix
    (Zhou et al.; reference optim/utils.py:22-37): Gram-Schmidt on the two
    3-vectors, rows b1, b2, b1 x b2."""
    a1, a2 = r6[..., 0:3], r6[..., 3:6]
    b1 = _unit(a1)
    b2 = _unit(a2 - (b1 * a2).sum(-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rot6d(R: torch.Tensor) -> torch.Tensor:
    """First two rows of R, flattened."""
    return torch.cat([R[..., 0, :], R[..., 1, :]], dim=-1)


def apply_transformation(verts, rot6d, translation, scale=None):
    """``verts @ R^T * s + t`` (row vectors; reference
    optim/utils.py:56-62)."""
    out = verts @ rot6d_to_matrix(rot6d).T
    if scale is not None:
        out = out * scale
    return out + translation


def calculate_centroid(mask: torch.Tensor) -> torch.Tensor:
    """Soft centroid (row, col) of a [0, 1] mask (reference
    optim/utils.py)."""
    H, W = mask.shape
    total = _floor(mask.sum(), 1e-8)
    rows = torch.arange(H, dtype=mask.dtype, device=mask.device)
    cols = torch.arange(W, dtype=mask.dtype, device=mask.device)
    cy = (mask.sum(dim=1) * rows).sum() / total
    cx = (mask.sum(dim=0) * cols).sum() / total
    return torch.stack([cy, cx])


def normalized_distance(c1, c2, hw):
    """Distance between two (row, col) points over the image diagonal."""
    h, w = torch.tensor([float(hw[0]), float(hw[1])], dtype=torch.float32,
                        device=c1.device)
    return torch.linalg.norm(c1 - c2) / torch.sqrt(h ** 2 + w ** 2)


def compute_vertex_normals(verts: torch.Tensor,
                           faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals (reference render_mesh_utils.py:75-93):
    each face's cross product added to its three corners (one scatter over
    the corner-major index list), normalised. On the tensors' device."""
    faces = faces.long()
    v0 = verts[faces[:, 1]] - verts[faces[:, 0]]
    v1 = verts[faces[:, 2]] - verts[faces[:, 0]]
    fn = torch.linalg.cross(v0, v1)
    idx = faces.T.reshape(-1)
    n = torch.zeros_like(verts).index_add_(0, idx, fn.repeat(3, 1))
    return n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-8)
