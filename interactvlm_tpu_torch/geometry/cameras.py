"""Camera math in PyTorch3D conventions.

Port of ``interactvlm_tpu/geometry/cameras.py``. The reference builds its
cameras with ``look_at_view_transform`` + ``FoVPerspectiveCameras``
(reference ``preprocess_data/render_mesh_utils.py:115-127``); the same
conventions hold here, so lift maps built by the port are interchangeable
with the reference's:

- world -> camera: row-vector transform ``p_cam = p @ R + T``;
- the camera looks down +Z; NDC +X points left, +Y points up;
- pixel (0, 0) is top-left and corresponds to NDC (+1, +1); pixel centres
  map to ``ndc = 1 - (2 * i + 1) / S``.

A camera is five numbers, so ``look_at_view_transform`` and
``camera_from_params`` run on the host, in f32 and the JAX package's order
of operations, whatever device the points are on: the rasterizer then sees
the same R and T on every device. ``project_points`` uses element-wise
operations only (no matmul), each rounded once as IEEE prescribes on the
CPU and on the card, so its pixels are the same bits on both.
"""

from __future__ import annotations

import torch

F32 = torch.float32


def _host(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32, device="cpu")


def _normalize(v, eps: float = 1e-8):
    return v / torch.clamp_min(torch.linalg.vector_norm(v), eps)


def look_at_view_transform(dist, elev, azim, degrees: bool = True):
    """Rotation and translation of a camera orbiting the origin.

    Matches PyTorch3D ``look_at_view_transform`` with ``at=(0, 0, 0)``,
    ``up=(0, 1, 0)``. Returns ``R`` (3, 3) and ``T`` (3,) f32 on the CPU,
    used as ``p_cam = p @ R + T``.
    """
    dist, elev, azim = _host(dist), _host(elev), _host(azim)
    if degrees:
        elev = torch.deg2rad(elev)
        azim = torch.deg2rad(azim)
    # nudge away from the view axis (anti)parallel to the up vector (elev =
    # +-90: the object 'top' / 'bottom' views), where look-at is undefined
    elev = torch.where(torch.cos(elev).abs() < 1e-6, elev - 1e-5, elev)
    x = dist * torch.cos(elev) * torch.sin(azim)
    y = dist * torch.sin(elev)
    z = dist * torch.cos(elev) * torch.cos(azim)
    eye = torch.stack([x, y, z])

    up = torch.tensor([0.0, 1.0, 0.0], dtype=F32)
    z_axis = _normalize(torch.zeros(3, dtype=F32) - eye)
    x_axis = _normalize(torch.linalg.cross(up, z_axis))
    y_axis = _normalize(torch.linalg.cross(z_axis, x_axis))

    R = torch.stack([x_axis, y_axis, z_axis], dim=-1)  # columns
    T = -eye @ R
    return R, T


def camera_from_params(cam_params):
    """5-dof ``(dist, elev, azim, tx, ty)`` -> (R, T), f32 on the CPU.

    The translation offsets are added to T in camera space, as in the
    reference (``render_mesh_utils.py:118-119``).
    """
    dist, elev, azim, tx, ty = _host(cam_params).reshape(5)
    R, T = look_at_view_transform(dist, elev, azim)
    return R, T + torch.stack([tx, ty, torch.zeros((), dtype=F32)])


def project_points(verts, R, T, image_size: int, fov_degrees: float = 60.0):
    """Project world-space points to pixel coordinates.

    Returns ``(xy_pix, z_cam)``: ``xy_pix`` (N, 2) float pixel coordinates
    (x = column, y = row; pixel centres at integers) and ``z_cam`` (N,) the
    camera-space depth used for z-buffering, on the points' device.

    Conventions follow PyTorch3D ``FoVPerspectiveCameras`` (fov 60, square
    aspect): ``ndc = f * xy_cam / z_cam`` with ``f = 1 / tan(fov / 2)``,
    then ``pix = ((1 - ndc) * S - 1) / 2`` on both axes.
    """
    R, T = R.to(verts.device, F32), T.to(verts.device, F32)
    p_cam = (verts[..., 0:1] * R[0] + verts[..., 1:2] * R[1]
             + verts[..., 2:3] * R[2]) + T
    z = p_cam[..., 2]
    f = float(torch.ones((), dtype=F32)
              / torch.tan(torch.deg2rad(_host(fov_degrees)) / 2.0))
    safe_z = torch.where(z.abs() < 1e-8, 1e-8, z)
    ndc = f * p_cam[..., :2] / safe_z[..., None]
    pix = ((1.0 - ndc) * image_size - 1.0) * 0.5
    return pix, z


def pixel_centers_ndc(image_size: int, device="cpu"):
    """NDC coordinate of each pixel centre along one axis, index-ordered."""
    i = torch.arange(image_size, dtype=F32, device=device)
    size = torch.full((), image_size, dtype=F32, device=device)
    return 1.0 - (2.0 * i + 1.0) / size
