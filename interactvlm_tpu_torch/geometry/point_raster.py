"""Point-cloud rasterization and pixel -> point maps.

Port of ``interactvlm_tpu/geometry/point_raster.py`` (the replacement of
the PyTorch3D point rasterizer of the reference's object pipeline,
``preprocess_data/utils_obj_pc.py:28-113``): each point splats a square of
pixels; a ``scatter_reduce_`` amin z-buffer keeps the nearest depth per
pixel, then the lowest point id among the candidates at that depth wins,
which gives the p2p map the affordance lift takes; plus position-RGB
renders and heatmaps (utils_obj_pc.py:115-151, :261-268). Every function
runs on its inputs' device.
"""

from __future__ import annotations

import torch

from interactvlm_tpu_torch.geometry.cameras import (
    camera_from_params,
    project_points,
)
from interactvlm_tpu_torch.geometry.lift import lift_multiview_points
from interactvlm_tpu_torch.geometry.rasterizer import INT_BIG


def rasterize_points(points, cam_params, image_size: int, radius: int = 2,
                     fov_degrees: float = 60.0, znear: float = 0.05):
    """Z-buffered square splats of (P, 3) world-space points under one
    camera ``(dist, elev, azim, tx, ty)``; ``radius`` is the splat's
    half-width in pixels. Returns p2p (S, S) int32 (-1 empty) and zbuf
    (S, S) f32 (+inf empty)."""
    S, dev = image_size, points.device
    pix, z = project_points(points, *camera_from_params(cam_params), S,
                            fov_degrees)
    w = 2 * radius + 1
    offs = torch.arange(w, dtype=torch.int32, device=dev) - radius
    # the nearest pixel (half to even), clamped off screen before the cast
    c = torch.round(pix).clamp(-2 * S, 2 * S).to(torch.int32)  # (P, 2)
    px = c[:, 0:1] + offs.repeat(w)[None]
    py = c[:, 1:2] + offs.repeat_interleave(w)[None]
    valid = (px >= 0) & (px < S) & (py >= 0) & (py < S) & (z > znear)[:, None]
    n_pix = S * S
    pix_id = torch.where(valid, py * S + px, n_pix).reshape(-1).long()
    valid = valid.reshape(-1)
    z_flat = torch.where(valid, z[:, None].expand(px.shape).reshape(-1),
                         torch.inf)
    zmin = torch.full((n_pix + 1,), torch.inf, device=dev).scatter_reduce_(
        0, pix_id, z_flat, "amin")
    at_front = valid & (z_flat <= zmin[pix_id])
    pid = torch.arange(points.shape[0], dtype=torch.int32, device=dev
                       )[:, None].expand(px.shape).reshape(-1)
    winner = torch.full((n_pix + 1,), INT_BIG, dtype=torch.int32, device=dev
                        ).scatter_reduce_(0, pix_id,
                                          torch.where(at_front, pid, INT_BIG),
                                          "amin")[:n_pix]
    p2p = torch.where(winner < INT_BIG, winner, -1)
    return p2p.reshape(S, S), zmin[:n_pix].reshape(S, S)


def normalize_point_cloud(points):
    """Centre and scale into the unit sphere (reference utils_obj_pc)."""
    p = points - points.mean(dim=0)
    scale = torch.linalg.norm(p, dim=1).max()
    return p / torch.maximum(scale, scale.new_tensor(1e-8))


def position_rgb_render(points, p2p, background=1.0):
    """Per-pixel colour = the normalised point position (the reference's
    position-RGB object renders, utils_obj_pc.py:261-268)."""
    lo, hi = points.amin(0), points.amax(0)
    colors = (points - lo) / torch.maximum(hi - lo, lo.new_tensor(1e-8))
    safe = p2p.clamp(0, points.shape[0] - 1).long()
    return torch.where((p2p >= 0)[..., None], colors[safe], background)


def heatmap_render(values, p2p, background=0.0):
    """Per-pixel scalar = the point's value (affordance heatmaps,
    utils_obj_pc.py:115-151)."""
    safe = p2p.clamp(0, values.shape[0] - 1).long()
    return torch.where(p2p >= 0, values[safe], background)


def lift_points_roundtrip(values, p2p_maps, num_points: int):
    """Datagen-time check: render per-view heatmaps and lift them back
    (reference lift_masks_to_pointcloud, utils_obj_pc.py:47-86)."""
    p2p = torch.stack(list(p2p_maps))
    return lift_multiview_points(
        torch.stack([heatmap_render(values, m) for m in p2p]), p2p,
        num_points)
