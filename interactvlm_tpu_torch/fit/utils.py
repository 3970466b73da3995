"""Mesh helpers of the joint human-object fitting (the part of
``interactvlm_tpu/fit/utils.py`` the datagen recipes need)."""

from __future__ import annotations

import torch


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
