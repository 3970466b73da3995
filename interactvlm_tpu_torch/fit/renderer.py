"""Differentiable soft-silhouette rasterizer and hard preview renderers of
the joint human-object fit.

Port of ``interactvlm_tpu/fit/renderer.py`` (the replacement of the
PyTorch3D SoftSilhouette / HardPhong renderers of the reference's fitting
loop, ``optim/renderer.py:63-156``). Each face tests a fixed
``window x window`` block of candidate pixels anchored at its bounding box:

- the soft silhouette scatters each candidate's ``log(1 - p)`` into its
  pixel with ``index_add`` (slot ``S * S`` collects the invalid ones) and
  composes ``alpha = 1 - exp(sum)``, differentiable in the vertices through
  the screen-space point-to-edge distances;
- the hard renderers resolve visibility with ``scatter_reduce_(..., "amin")``
  z-buffers, exact and deterministic on the CPU and on the card.

The JAX package compiles ``soft_silhouette`` and ``render_phong`` (with its
``_rasterize_winner``), and XLA's CPU code contracts their edge functions,
areas and interpolated depths into fused multiply-adds: the port decides
inside / outside and visibility from those values rounded the same way
(``geometry/rasterizer.py:_cross`` and ``_fma``), so it covers the same
pixels. ``render_depth`` runs op by op in the JAX package, each product
rounded, and the port rounds it so too. The clamps are ``jnp.clip``'s
(``geometry/lift.py:clip``): half the gradient on a bound.

The JAX package's ``soft_silhouette`` and ``_rasterize_winner`` test the
area with ``(jnp.abs(area) > 1e-9)[:, None]`` on an area that is already
(F, 1), so their validity mask is (F, F, W2): candidate (j, k) enters once
for every face i that is not degenerate, and face j's own area is never
tested. The port gives that result at (F, W2): the soft silhouette's sum of
``log(1 - p)`` over the front, on-screen candidates times the number of
non-degenerate faces (``alpha = 1 - prod(1 - p) ** n``), and the winner's
candidates without their own area test (a min does not count repeats). At
the full fit size (F = 4092, window 16) the JAX mask would hold 4.3e9
entries.
"""

from __future__ import annotations

import torch

from interactvlm_tpu_torch.geometry.lift import clip
from interactvlm_tpu_torch.geometry.rasterizer import _cross, _fma
from interactvlm_tpu_torch.fit.utils import _floor, _unit


def _like(x, ref):
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def project_perspective(verts, focal, princpt, flip: bool = True):
    """Perspective projection with screen-space intrinsics (reference
    camera, ``optim/renderer.py:28-43``): R = diag(-1, -1, 1) flips x and y
    before projecting; focal and principal point in pixels. Returns
    (xy_pix (N, 2), z (N,))."""
    v = verts
    if flip:
        v = v * v.new_tensor([-1.0, -1.0, 1.0])
    z = v[..., 2]
    safe_z = torch.where(z.abs() < 1e-6, 1e-6, z)
    xy = v[..., :2] * _like(focal, v) / safe_z[..., None] + _like(princpt, v)
    return xy, z


def _point_segment_sq_dist(p, a, b):
    """Squared distance from points p to segments (a, b); all (..., 2)."""
    ab = b - a
    t = ((p - a) * ab).sum(-1) / _floor((ab * ab).sum(-1), 1e-12)
    d = p - (a + clip(t, 0.0, 1.0)[..., None] * ab)
    return (d * d).sum(-1)


def _nondegenerate(area):
    """How many faces have |area| > 1e-9 px^2, as an f32 scalar."""
    return (area.abs() > 1e-9).sum().float()


def _candidates(tri, window: int, S: int, margin: int):
    """Each face's block of window^2 candidate pixels (px, py) (F, W2),
    anchored ``margin`` pixels before its bounding box's minimum and
    clamped into [-window, S] (in f32 before the cast, so that a face
    projected far out does not wrap)."""
    lo = torch.floor(tri.detach().amin(1)) - margin  # (F, 2)
    x0, y0 = lo.clamp(-window, S).to(torch.int32).unbind(-1)
    offs = torch.arange(window, dtype=torch.int32, device=tri.device)
    px = x0[:, None] + offs.repeat(window)[None]  # column within the block
    py = y0[:, None] + offs.repeat_interleave(window)[None]  # row
    return px, py


def soft_silhouette(verts_pix, z, faces, image_size: int, window: int = 16,
                    sigma: float = 1.0):
    """Soft coverage map (image_size, image_size) in [0, 1], differentiable
    in ``verts_pix`` (N, 2) projected pixel coordinates; ``z`` (N,) camera
    depths, ``faces`` (F, 3). ``sigma`` is in squared pixels (the
    reference's NDC sigma 1e-4 at a ~512 px frame is a few pixels^2)."""
    S = image_size
    faces = faces.long()
    tri = verts_pix[faces]  # (F, 3, 2)
    tri_z = z[faces]
    px, py = _candidates(tri, window, S, 2)
    p = torch.stack([px.float(), py.float()], -1)  # (F, W2, 2)
    a, b, c = tri[:, None, 0], tri[:, None, 1], tri[:, None, 2]

    # inside / outside by the sign of the edge functions (no gradient)
    with torch.no_grad():
        pxf, pyf = p[..., 0], p[..., 1]
        (ax, ay), (bx, by), (cx, cy) = (v.detach().unbind(-1)
                                        for v in (a, b, c))
        area = _cross(bx - ax, cy - ay, by - ay, cx - ax)  # (F, 1)
        w0 = _cross(cx - bx, pyf - by, cy - by, pxf - bx)
        w1 = _cross(ax - cx, pyf - cy, ay - cy, pxf - cx)
        w2 = _cross(bx - ax, pyf - ay, by - ay, pxf - ax)
        denom = torch.where(area.abs() < 1e-9, 1.0, area)
        inside = (w0 / denom >= 0) & (w1 / denom >= 0) & (w2 / denom >= 0)

    d2 = torch.minimum(_point_segment_sq_dist(p, a, b), torch.minimum(
        _point_segment_sq_dist(p, b, c), _point_segment_sq_dist(p, c, a)))
    signed = torch.where(inside, d2, -d2)
    prob = torch.sigmoid(signed / sigma)  # ~1 inside, soft falloff outside

    front = (tri_z > 1e-4).all(dim=1)[:, None]
    in_bounds = (px >= 0) & (px < S) & (py >= 0) & (py < S)
    valid = front & in_bounds
    log_one_minus = torch.where(
        valid, torch.log1p(-clip(prob, 0.0, 1.0 - 1e-6)), 0.0)
    pix_id = torch.where(valid, py * S + px, S * S).reshape(-1).long()
    acc = torch.zeros(S * S + 1, dtype=prob.dtype, device=prob.device
                      ).index_add(0, pix_id, log_one_minus.reshape(-1))
    # the JAX package's (F, F, W2) validity counts every candidate once per
    # non-degenerate face (see the module's docstring)
    return (1.0 - torch.exp(acc[: S * S] * _nondegenerate(area))).reshape(S, S)


def render_silhouette(verts, faces, focal, princpt, image_size: int,
                      window: int = 16, sigma: float = 1.0):
    """World-space mesh -> soft silhouette (differentiable in verts)."""
    xy, z = project_perspective(verts, focal, princpt)
    return soft_silhouette(xy, z, faces, image_size, window, sigma)


def _rasterize_winner(xy, z, faces, image_size: int, window: int):
    """Windowed candidate rasterization -> per-pixel winner face id.

    Returns (winner (S*S,) int32 with ``F`` as the no-hit sentinel, zbuf
    (S*S,) f32). Pass 1 takes the nearest depth per pixel, pass 2 the
    lowest face id among the candidates within a small tolerance of it,
    each a ``scatter_reduce_`` amin. Pixel centres at +0.5."""
    S, F = image_size, faces.shape[0]
    faces = faces.long()
    tri, tri_z = xy[faces], z[faces]
    px, py = _candidates(tri, window, S, 0)
    pxf, pyf = px.float() + 0.5, py.float() + 0.5
    (ax, ay), (bx, by), (cx, cy) = (tri[:, i, None].unbind(-1)
                                    for i in range(3))
    w0 = _cross(cx - bx, pyf - by, cy - by, pxf - bx)
    w1 = _cross(ax - cx, pyf - cy, ay - cy, pxf - cx)
    w2 = _cross(bx - ax, pyf - ay, by - ay, pxf - ax)
    area = _cross(bx - ax, cy - ay, by - ay, cx - ax)
    denom = torch.where(area.abs() < 1e-9, 1.0, area)
    b0, b1, b2 = w0 / denom, w1 / denom, w2 / denom
    inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
    zi = _fma(b2, tri_z[:, 2:3], _fma(b0, tri_z[:, 0:1], b1 * tri_z[:, 1:2]))
    # the JAX package's (F, F, W2) validity: a face's own area is not
    # tested, only that some face is not degenerate (see the docstring)
    valid = (inside & (px >= 0) & (px < S) & (py >= 0) & (py < S)
             & (zi > 1e-4) & (_nondegenerate(area) > 0))
    pix = torch.where(valid, py * S + px, S * S).reshape(-1).long()
    zf = torch.where(valid, zi, torch.inf).reshape(-1)
    zmin = torch.full((S * S + 1,), torch.inf, device=xy.device
                      ).scatter_reduce_(0, pix, zf, "amin")
    # pass 2: among candidates matching the z-buffer (small tolerance),
    # the lowest face id wins
    front = zmin[(py * S + px).clamp(0, S * S - 1).long()]
    at_front = valid & (zi <= front * (1.0 + 1e-6) + 1e-6)
    fid = torch.arange(F, dtype=torch.int32, device=xy.device)[:, None]
    fm = torch.where(at_front, fid, F).reshape(-1)
    winner = torch.full((S * S + 1,), F, dtype=torch.int32, device=xy.device
                        ).scatter_reduce_(0, pix, fm, "amin")
    return winner[: S * S], zmin[: S * S]


def vertex_normals(verts, faces):
    """Area-weighted per-vertex normals (outward given CCW faces): one
    scatter-add pass per corner, normalised. The sums come in another order
    than ``fit/utils.py:compute_vertex_normals``' single pass."""
    faces = faces.long()
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = torch.linalg.cross(b - a, c - a)  # area-weighted
    n = torch.zeros_like(verts)
    for i in range(3):
        n = n.index_add(0, faces[:, i], fn)
    return _unit(n)


def render_phong(verts, faces, focal, princpt, image_size: int,
                 window: int = 16, color=(0.65, 0.74, 0.86),
                 ambient: float = 0.35, diffuse: float = 0.55,
                 specular: float = 0.25, shininess: float = 32.0):
    """Hard-Phong shaded render (image_size, image_size, 4) RGBA in [0, 1]
    (the reference HPRenderer's ``HardPhongShader``,
    ``optim/renderer.py:104-156``): winner-face z-buffer, per-pixel
    barycentric normal interpolation, head-light Phong shading (the light
    at the camera), two-sided."""
    S, F = image_size, faces.shape[0]
    faces = faces.long()
    xy, z = project_perspective(verts, focal, princpt)
    winner, _ = _rasterize_winner(xy, z, faces, S, window)
    hit = winner < F
    wf = torch.where(hit, winner, 0).long()

    # camera-frame geometry (the projection flips x / y; so do the normals)
    v_cam = verts * verts.new_tensor([-1.0, -1.0, 1.0])
    n_vert = vertex_normals(v_cam, faces)
    corners = faces[wf]  # (S*S, 3)
    tri_xy, tri_n, tri_v = xy[corners], n_vert[corners], v_cam[corners]

    g = torch.arange(S, dtype=torch.float32, device=verts.device) + 0.5
    gx, gy = g.repeat(S), g.repeat_interleave(S)
    (ax, ay), (bx, by), (cx, cy) = (tri_xy[:, i].unbind(-1) for i in range(3))
    w0 = _cross(cx - bx, gy - by, cy - by, gx - bx)
    w1 = _cross(ax - cx, gy - cy, ay - cy, gx - cx)
    w2 = _cross(bx - ax, gy - ay, by - ay, gx - ax)
    area = _cross(bx - ax, cy - ay, by - ay, cx - ax)
    denom = torch.where(area.abs() < 1e-9, 1.0, area)
    bary = torch.stack([w0, w1, w2], -1) / denom[:, None]  # (S*S, 3)

    n = _unit((bary[:, :, None] * tri_n).sum(1))
    p = (bary[:, :, None] * tri_v).sum(1)  # surface point, camera frame
    view = -_unit(p)
    # two-sided shading: meshes in the wild have inconsistent winding
    n = torch.where((n * view).sum(-1, keepdim=True) < 0, -n, n)
    lam = clip((n * view).sum(-1), 0.0, 1.0)  # head-light: L == V
    refl = 2.0 * lam[:, None] * n - view
    spec = clip((refl * view).sum(-1), 0.0, 1.0) ** shininess
    shade = ambient + diffuse * lam
    rgb = (shade[:, None] * verts.new_tensor(color)[None]
           + specular * spec[:, None])
    rgb = clip(rgb, 0.0, 1.0) * hit[:, None]
    return torch.cat([rgb, hit[:, None].float()], -1).reshape(S, S, 4)


def render_depth(verts, faces, focal, princpt, image_size: int,
                 window: int = 16):
    """Hard z-buffer depth map (S, S), +inf where empty (not
    differentiable; preview and initialisation). Pixel corners at the
    integers, every product rounded on its own."""
    S = image_size
    faces = faces.long()
    xy, z = project_perspective(verts, focal, princpt)
    tri, tri_z = xy[faces], z[faces]
    px, py = _candidates(tri, window, S, 0)
    pxf, pyf = px.float(), py.float()
    (ax, ay), (bx, by), (cx, cy) = (tri[:, i, None].unbind(-1)
                                    for i in range(3))
    w0 = (cx - bx) * (pyf - by) - (cy - by) * (pxf - bx)
    w1 = (ax - cx) * (pyf - cy) - (ay - cy) * (pxf - cx)
    w2 = (bx - ax) * (pyf - ay) - (by - ay) * (pxf - ax)
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    denom = torch.where(area.abs() < 1e-9, 1.0, area)
    b0, b1, b2 = w0 / denom, w1 / denom, w2 / denom
    inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
    zi = b0 * tri_z[:, 0:1] + b1 * tri_z[:, 1:2] + b2 * tri_z[:, 2:3]
    valid = (inside & (px >= 0) & (px < S) & (py >= 0) & (py < S)
             & (zi > 1e-4) & (area.abs() > 1e-9))
    pix = torch.where(valid, py * S + px, S * S).reshape(-1).long()
    zf = torch.where(valid, zi, torch.inf).reshape(-1)
    zmin = torch.full((S * S + 1,), torch.inf, device=xy.device
                      ).scatter_reduce_(0, pix, zf, "amin")
    return zmin[: S * S].reshape(S, S)
