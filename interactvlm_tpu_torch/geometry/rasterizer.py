"""Mesh rasterization into pixel -> face / pixel -> vertex and barycentric
maps: the lift maps of the 2D <-> 3D contact lift.

Port of ``interactvlm_tpu/geometry/rasterizer.py`` (the replacement of the
PyTorch3D rasterizer the reference uses for its lift maps,
``preprocess_data/render_mesh_utils.py:115-174``). Each face tests a fixed
``window x window`` block of candidate pixels anchored at its bounding box;
a z-buffer over all candidates resolves visibility:

- the nearest depth per pixel and, among the candidates at that depth, the
  lowest face index, each by ``scatter_reduce_(..., "amin")``, which is
  exact and deterministic on the CPU and on the card (an accumulating
  ``index_put_`` is not: the card does not fix its order);
- screen-space (not perspective-correct) barycentrics, as the reference's
  settings give (``blur_radius=0``, ``faces_per_pixel=1``);
- pixels that no face covers get face -1 and zero barycentrics.

Every step is an element-wise operation, a gather or a min-scatter, each
rounded as IEEE prescribes, so the CPU and the card build the same maps
bit for bit. The candidates number F x window^2 (12 million for the
6890-vertex sphere at 1024^2): ``pick_window`` gives the smallest safe
window for a mesh and camera, as ``bench.py`` sizes it.
"""

from __future__ import annotations

import numpy as np
import torch

from interactvlm_tpu_torch.geometry.cameras import (
    camera_from_params,
    project_points,
)
from interactvlm_tpu_torch.utils.device import resolve_device

INT_BIG = 2 ** 30


def _fma(a, b, c):
    """a * b + c in f32 rounded once, as a fused multiply-add rounds it
    (the JAX package's compiled code contracts these sums so on the CPU):
    the product of two f32 values is exact in f64, so the f64 sum rounded
    to f32 is that result on either device."""
    return (a.double() * b.double() + c.double()).float()


def _cross(a, b, c, d):
    """a * b - c * d as one fused multiply-add over the rounded c * d."""
    return _fma(a, b, -(c * d))


def rasterize_mesh(verts, faces, cam_params, image_size: int,
                   window: int = 32, fov_degrees: float = 60.0,
                   znear: float = 0.05):
    """Rasterize one mesh under one camera, on the vertices' device.

    Args:
      verts: (N, 3) f32 world-space vertices.
      faces: (F, 3) integer vertex indices, on the vertices' device.
      cam_params: (5,) ``(dist, elev, azim, tx, ty)``.
      image_size: output resolution S (square).
      window: candidate block size in pixels; at least the largest
        projected triangle's bounding box (``pick_window``).

    Returns:
      pix_to_face: (S, S) int32, -1 where empty.
      bary: (S, S, 3) f32 barycentrics of the visible face.
      zbuf: (S, S) f32 camera-space depth (+inf where empty).
    """
    pix, z = project_points(verts, *camera_from_params(cam_params),
                            image_size, fov_degrees)
    return rasterize_projected(pix, z, faces, image_size, window, znear)


def rasterize_projected(pix, z, faces, image_size: int, window: int = 32,
                        znear: float = 0.05):
    """The z-buffer of ``rasterize_mesh`` on projected vertices: ``pix``
    (N, 2) pixel coordinates and ``z`` (N,) camera-space depths from
    ``project_points``; returns what ``rasterize_mesh`` returns."""
    S, dev = image_size, pix.device
    faces = faces.long()
    tri_xy = pix[faces]  # (F, 3, 2)
    tri_z = z[faces]  # (F, 3)

    # candidate block per face, anchored at the bounding box's minimum and
    # clamped into [-window, S] so that off-screen faces do not wrap (in
    # f32 before the cast: a face behind the camera projects far out)
    x0 = torch.floor(tri_xy[:, :, 0].amin(1)).clamp(-window, S).to(torch.int32)
    y0 = torch.floor(tri_xy[:, :, 1].amin(1)).clamp(-window, S).to(torch.int32)
    offs = torch.arange(window, dtype=torch.int32, device=dev)
    ox = offs.repeat(window)  # column within the block
    oy = offs.repeat_interleave(window)  # row within the block
    px = x0[:, None] + ox[None, :]  # (F, W2)
    py = y0[:, None] + oy[None, :]
    pxf, pyf = px.float(), py.float()

    ax, ay = tri_xy[:, 0, 0], tri_xy[:, 0, 1]
    bx, by = tri_xy[:, 1, 0], tri_xy[:, 1, 1]
    cx, cy = tri_xy[:, 2, 0], tri_xy[:, 2, 1]

    def edge(ox_, oy_, dx_, dy_):
        # cross(d - o, p - o): the signed area of (o, d, p) at every
        # candidate pixel, of the same sign convention as ``area``
        return _cross((dx_ - ox_)[:, None], pyf - oy_[:, None],
                      (dy_ - oy_)[:, None], pxf - ox_[:, None])

    w0 = edge(bx, by, cx, cy)  # opposite vertex a
    w1 = edge(cx, cy, ax, ay)  # opposite vertex b
    w2 = edge(ax, ay, bx, by)  # opposite vertex c
    area = _cross(bx - ax, cy - ay, by - ay, cx - ax)  # (F,)
    degenerate = area.abs() <= 1e-12
    denom = torch.where(area.abs() < 1e-12, 1.0, area)[:, None]
    b0, b1, b2 = w0 / denom, w1 / denom, w2 / denom

    inside = (b0 >= 0.0) & (b1 >= 0.0) & (b2 >= 0.0)
    z_interp = _fma(b2, tri_z[:, 2:3], _fma(b0, tri_z[:, 0:1],
                                            b1 * tri_z[:, 1:2]))  # (F, W2)
    in_bounds = (px >= 0) & (px < S) & (py >= 0) & (py < S)
    valid = inside & in_bounds & (z_interp > znear) & ~degenerate[:, None]

    n_pix = S * S
    pixel_id = torch.where(valid, py * S + px, n_pix).reshape(-1).long()
    face_id = torch.arange(faces.shape[0], dtype=torch.int32,
                           device=dev)[:, None].expand(valid.shape).reshape(-1)
    valid = valid.reshape(-1)

    # pass 1: the nearest depth per pixel (slot n_pix collects the invalid)
    z_flat = torch.where(valid, z_interp.reshape(-1), torch.inf)
    zmin = torch.full((n_pix + 1,), torch.inf, device=dev).scatter_reduce_(
        0, pixel_id, z_flat, "amin")
    at_front = valid & (z_flat <= zmin[pixel_id])

    # pass 2: depth ties go to the lowest face index
    face_masked = torch.where(at_front, face_id, INT_BIG)
    winner = torch.full((n_pix + 1,), INT_BIG, dtype=torch.int32,
                        device=dev).scatter_reduce_(0, pixel_id, face_masked,
                                                    "amin")
    is_winner = at_front & (face_id == winner[pixel_id])

    # pass 3: the winner's barycentrics; a face has one candidate a pixel,
    # so each pixel has at most one winner and the write needs no order
    bary_all = torch.stack([b0.reshape(-1), b1.reshape(-1), b2.reshape(-1)],
                           dim=-1)
    bary = torch.zeros(n_pix + 1, 3, device=dev)
    bary[pixel_id[is_winner]] = bary_all[is_winner]

    pix_to_face = torch.where(winner[:n_pix] < INT_BIG, winner[:n_pix], -1)
    return (pix_to_face.reshape(S, S), bary[:n_pix].reshape(S, S, 3),
            zmin[:n_pix].reshape(S, S))


def pick_window(verts, faces, cam_params, image_size: int,
                fov_degrees: float = 60.0) -> int:
    """The smallest safe ``window`` for a mesh and view: the largest
    projected triangle's bounding-box extent + 2 (at least 4). On the
    host."""
    verts = torch.as_tensor(np.asarray(verts, np.float32))
    pix, _ = project_points(verts, *camera_from_params(cam_params),
                            image_size, fov_degrees)
    tri = pix.numpy()[np.asarray(faces)]  # (F, 3, 2)
    ext = tri.max(axis=1) - np.floor(tri.min(axis=1))
    return max(int(np.ceil(ext.max())) + 2, 4)


def faces_contact_mask(faces, contact_vertex_mask, min_vertices: int = 2):
    """Per-face flag: does the face touch at least ``min_vertices`` contact
    vertices? (Reference ``render_mesh_utils.py:138-143``, ``min_vertices``
    2 per the FIX.md release notes.)"""
    counts = contact_vertex_mask.to(torch.int32)[faces.long()].sum(-1)
    return counts >= min_vertices


def contact_mask_from_fragments(pix_to_face, faces, contact_vertex_mask,
                                min_vertices: int = 2):
    """The ground-truth contact mask of one rendered view, boolean
    (reference ``render_mesh_utils.py:138-143``)."""
    face_flag = faces_contact_mask(faces, contact_vertex_mask, min_vertices)
    safe = pix_to_face.clamp(0, faces.shape[0] - 1).long()
    return torch.where(pix_to_face >= 0, face_flag[safe], False)


def build_lift_maps(verts, faces, cam_params_per_view, image_size: int,
                    window: int = 32, fov_degrees: float = 60.0,
                    device="cuda"):
    """Per-view pixel -> vertex and barycentric lift maps, built on
    ``device`` (the card unless the caller names the CPU), one view at a
    time (replaces the reference's p2v / bary npz generation,
    ``render_mesh_utils.py:145-174``).

    Returns p2v (V, S, S, 3) int32 vertex ids (-1 where empty), bary
    (V, S, S, 3) f32 and pix_to_face (V, S, S) int32. ``geometry/lift.py``
    takes the maps corner-major (``corner_major``).
    """
    dev = resolve_device(device)
    verts = torch.as_tensor(np.asarray(verts, np.float32), device=dev)
    faces = torch.as_tensor(np.asarray(faces, np.int64), device=dev)
    p2v, bary, p2f = [], [], []
    for cp in np.asarray(cam_params_per_view, np.float32):
        pix_to_face, b, _ = rasterize_mesh(verts, faces, cp, image_size,
                                           window, fov_degrees)
        safe = pix_to_face.clamp(0, faces.shape[0] - 1).long()
        p2v.append(torch.where((pix_to_face >= 0)[..., None], faces[safe],
                               -1).to(torch.int32))
        bary.append(b)
        p2f.append(pix_to_face)
    return torch.stack(p2v), torch.stack(bary), torch.stack(p2f)


def uv_sphere(n_lat: int = 60, n_lon: int = 80, radius: float = 0.8):
    """A UV sphere as (verts (N, 3) f32, faces (F, 3) int32) numpy arrays,
    faces wound as ``bench.py``'s test body winds them: 2 + (n_lat - 1)
    n_lon vertices (n_lat 83, n_lon 84 give the 6890 of SMPL)."""
    verts = [(0.0, radius, 0.0)]
    for i in range(1, n_lat):
        t = np.pi * i / n_lat
        for j in range(n_lon):
            p = 2 * np.pi * j / n_lon
            verts.append((radius * np.sin(t) * np.cos(p),
                          radius * np.cos(t),
                          radius * np.sin(t) * np.sin(p)))
    verts.append((0.0, -radius, 0.0))
    faces = []
    for j in range(n_lon):
        faces.append((0, 1 + j, 1 + (j + 1) % n_lon))
    for i in range(n_lat - 2):
        r0, r1 = 1 + i * n_lon, 1 + (i + 1) * n_lon
        for j in range(n_lon):
            a, b = r0 + j, r0 + (j + 1) % n_lon
            c, d = r1 + j, r1 + (j + 1) % n_lon
            faces += [(a, c, b), (b, c, d)]
    last = len(verts) - 1
    ring = 1 + (n_lat - 2) * n_lon
    for j in range(n_lon):
        faces.append((last, ring + (j + 1) % n_lon, ring + j))
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)
