"""Offline data generation: canonical renders, GT contact masks and lift
maps.

Port of ``interactvlm_tpu/datagen/generate.py`` (a rebuild of the reference
``preprocess_data`` scripts: ``generate_damon_human_mask.py``,
``generate_*_obj_heatmap.py``, ``render_mesh_utils.py``) on the port's
rasterizers:

- ``vitruvian_pose``: the 30-degree leg-splay body pose
  (render_mesh_utils.py:68-73), numpy;
- ``generate_human_assets``: the shared pixel -> vertex / barycentric maps
  of a posed body mesh and one GT contact mask per (sample, object, view),
  rasterized on ``device`` (``geometry/rasterizer.py``);
- ``verify_contact_reconstruction``: the project -> lift round trip
  (render_mesh_utils.py:200-235) through ``geometry/lift.py``;
- ``generate_object_assets``: a normalised point cloud's position-RGB
  renders, affordance heatmaps and pixel -> point maps
  (``geometry/point_raster.py``).

Every function that rasterizes takes ``device``: None means the device of
the first tensor argument, else the card (``pick_device``); the CPU runs
only when the caller names it. Results come back as numpy arrays, as the
JAX package returns them.
"""

from __future__ import annotations

import os
from os.path import join
from typing import Dict, Optional

import numpy as np
import torch

from interactvlm_tpu_torch.geometry.lift import corner_major, lift_multiview_soft
from interactvlm_tpu_torch.geometry.point_raster import (
    heatmap_render,
    normalize_point_cloud,
    position_rgb_render,
    rasterize_points,
)
from interactvlm_tpu_torch.geometry.rasterizer import (
    build_lift_maps,
    contact_mask_from_fragments,
    pick_window,
)
from interactvlm_tpu_torch.geometry.views import ViewSet
from interactvlm_tpu_torch.utils.device import resolve_device


def pick_device(x, device=None) -> torch.device:
    """Where a datagen function runs: ``device``, else the device of ``x``
    when it is a tensor, else the card (``resolve_device`` raises when
    there is none)."""
    if device is None:
        device = x.device if torch.is_tensor(x) else "cuda"
    return resolve_device(device)


def host(x, dtype=None) -> np.ndarray:
    """A tensor or array as a numpy array on the host."""
    arr = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return arr if dtype is None else arr.astype(dtype, copy=False)


def euler_to_matrix(euler_xyz: np.ndarray) -> np.ndarray:
    """Batch euler (N, 3) -> rotation matrices (N, 3, 3) via quaternions
    (reference render_mesh_utils.py:28-66 convention)."""
    x, y, z = euler_xyz[:, 0] / 2, euler_xyz[:, 1] / 2, euler_xyz[:, 2] / 2
    cx, sx = np.cos(x), np.sin(x)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(z), np.sin(z)
    w = cx * cy * cz - sx * sy * sz
    i = cx * sy * sz + cy * cz * sx
    j = cx * cz * sy - sx * cy * sz
    k = cx * cy * sz + sx * cz * sy
    q = np.stack([w, i, j, k], 1)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack(
        [
            np.stack([w * w + x * x - y * y - z * z, 2 * (x * y - w * z),
                      2 * (w * y + x * z)], 1),
            np.stack([2 * (w * z + x * y), w * w - x * x + y * y - z * z,
                      2 * (y * z - w * x)], 1),
            np.stack([2 * (x * z - w * y), 2 * (w * x + y * z),
                      w * w - x * x - y * y + z * z], 1),
        ],
        1,
    )


def vitruvian_pose(angle_deg: float = 30.0) -> np.ndarray:
    """SMPL body pose (21, 3, 3) with the legs splayed +-30 degrees about z
    (reference get_virtuvian_body_pose, render_mesh_utils.py:68-73)."""
    pose = np.zeros((21, 3), np.float32)
    a = np.deg2rad(angle_deg)
    pose[0, 2] = a
    pose[1, 2] = -a
    return euler_to_matrix(pose)


def lift_maps_on(verts, faces, view_set: ViewSet, image_size: int, device):
    """``build_lift_maps`` of a mesh under every view of ``view_set`` at
    the smallest safe window (picked on the host): p2v, bary (V, S, S, 3)
    and pix_to_face (V, S, S) as tensors on ``device``."""
    cams = view_set.cam_params()
    verts_np, faces_np = host(verts, np.float32), host(faces)
    w = max(pick_window(verts_np, faces_np, c, image_size) for c in cams)
    return build_lift_maps(verts_np, faces_np, cams, image_size, w,
                           device=device)


def contact_views(p2f, faces, contact_vertex_mask, min_vertices: int = 2):
    """One GT contact mask a view (V, S, S) bool, on the device of the
    fragments ``p2f`` (V, S, S); ``faces`` and the per-vertex mask move
    there."""
    dev = p2f.device
    faces = torch.as_tensor(host(faces), device=dev)
    cmask = torch.as_tensor(host(contact_vertex_mask), device=dev)
    return torch.stack([contact_mask_from_fragments(p2f[v], faces, cmask,
                                                    min_vertices)
                        for v in range(p2f.shape[0])])


def generate_human_assets(
    verts,
    faces,
    view_set: ViewSet,
    image_size: int,
    contact_sets: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
    min_vertices: int = 2,
    out_dir: Optional[str] = None,
    verify: bool = True,
    device=None,
):
    """Canonical-body datagen: lift maps + per-(sample, object) GT masks.

    ``contact_sets``: {sample_id: {object_name: contact vertex ids}}.
    Returns a dict with p2v / bary / pix_to_face ((V, S, S, ...) numpy),
    masks {(sample, obj): (V, S, S) bool} and, with ``verify``, the round
    trip's counts per (sample, obj); writes the reference's
    ``pixel_to_vertex_map_{S}.npz`` / ``bary_coords_map_{S}.npz`` pair
    when ``out_dir`` is set."""
    dev = pick_device(verts, device)
    p2v, bary, p2f = lift_maps_on(verts, faces, view_set, image_size, dev)
    out = {"p2v": host(p2v), "bary": host(bary), "pix_to_face": host(p2f),
           "masks": {}, "verify": {}}
    n = verts.shape[0]
    for sample_id, objs in (contact_sets or {}).items():
        for obj, ids in objs.items():
            cmask = np.zeros(n, bool)
            cmask[np.asarray(ids).reshape(-1)] = True
            views = contact_views(p2f, faces, cmask, min_vertices)
            out["masks"][(sample_id, obj)] = host(views)
            if verify:
                out["verify"][(sample_id, obj)] = \
                    verify_contact_reconstruction(views, p2v, bary, cmask)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        np.savez_compressed(
            join(out_dir, f"pixel_to_vertex_map_{image_size}.npz"),
            **{v: out["p2v"][i] for i, v in enumerate(view_set.names)})
        np.savez_compressed(
            join(out_dir, f"bary_coords_map_{image_size}.npz"),
            **{v: out["bary"][i] for i, v in enumerate(view_set.names)})
    return out


def verify_contact_reconstruction(masks, p2v, bary, contact_mask,
                                  threshold: float = 0.5, device=None):
    """Project -> lift round trip (reference
    verify_contact_reconstruction_diff, render_mesh_utils.py:200-235): the
    masks (V, S, S) as +-20 logits, lifted by ``lift_multiview_soft`` on
    the maps' device (``device``, else that of ``p2v``, else the card).
    Returns the missed, extra and correct counts over the visible
    vertices, and how many contact vertices are visible."""
    dev = pick_device(p2v, device)
    n = contact_mask.shape[0]
    masks = torch.as_tensor(host(masks), device=dev)
    p2v = torch.as_tensor(host(p2v), device=dev)
    bary = torch.as_tensor(host(bary), device=dev)
    logits = torch.where(masks, 20.0, -20.0)
    lifted = host(lift_multiview_soft(logits, corner_major(p2v),
                                      corner_major(bary), n))
    p2v = host(p2v)
    recon = set(np.where(lifted > threshold)[0])
    visible = set(np.unique(p2v[p2v >= 0]))
    orig = set(np.where(host(contact_mask))[0]) & visible
    return {
        "missed": len(orig - recon),
        "extra": len(recon - orig),
        "correct": len(orig & recon),
        "original_visible": len(orig),
    }


def generate_object_assets(
    points,
    view_set: ViewSet,
    image_size: int,
    affordance=None,
    radius: int = 2,
    out_dir: Optional[str] = None,
    object_id: str = "object",
    device=None,
):
    """Object point-cloud datagen: per-view position-RGB renders, heatmaps
    and p2p maps (reference generate_piad_obj_heatmap.py +
    utils_obj_pc.py), splatted on ``device`` (else that of ``points``,
    else the card). The cloud is centred and scaled on the host in f32,
    as the cameras are built, so every device splats the same points.
    Returns numpy arrays: points (P, 3), p2p (V, S, S) int32, renders
    (V, S, S, 3), heatmaps (V, S, S) or None; writes one
    ``p2pmap_{id}_{view}.npz`` a view when ``out_dir`` is set."""
    dev = pick_device(points, device)
    pts = normalize_point_cloud(torch.as_tensor(host(points, np.float32)))
    pts_dev = pts.to(dev)
    values = (None if affordance is None else
              torch.as_tensor(host(affordance, np.float32), device=dev))
    p2p_maps, renders, heatmaps = [], [], []
    for cam in view_set.cam_params():
        p2p, _ = rasterize_points(pts_dev, cam, image_size, radius)
        p2p_maps.append(p2p)
        renders.append(position_rgb_render(pts_dev, p2p))
        if values is not None:
            heatmaps.append(heatmap_render(values, p2p))
    out = {
        "points": host(pts),
        "p2p": host(torch.stack(p2p_maps)),
        "renders": host(torch.stack(renders)),
        "heatmaps": host(torch.stack(heatmaps)) if heatmaps else None,
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        for i, v in enumerate(view_set.names):
            np.savez_compressed(join(out_dir, f"p2pmap_{object_id}_{v}.npz"),
                                mapping=out["p2p"][i])
    return out
