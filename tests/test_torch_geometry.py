"""The port's geometry (cameras, the view registry, the rasterizer and its
lift maps) against the JAX package's, on the CPU.

Tolerances, with the reason for each:
- cameras (R, T), ``normalize_cam_params`` and ``project_points``: 1e-6.
  R and T come out bit for bit; the projection differs from XLA's by the
  rounding of ``verts @ R`` (XLA's CPU dot sums two of the three columns
  product by product and the third by fused multiply-adds; the port sums
  every column product by product so that the card and the CPU agree),
  a few f32 ulps of the pixel coordinate;
- the z-buffer (``rasterize_projected``) on the JAX package's own
  projection: face ids, barycentrics and depths exact, since the port
  rounds every sum as XLA's compiled code does (fused multiply-adds in the
  edge functions, the area and the depth);
- ``rasterize_mesh`` / ``build_lift_maps`` end to end: face and vertex ids
  equal at every pixel, none flipped by an edge or depth tie at these
  sizes (the tests count them and would have to prove each a tie);
  barycentrics within 1e-6, plus twice what the two projections' rounding
  moves them (computed in f64 at each pixel from each side's projected
  vertices), plus each side's f32 rounding bound for its edge functions:
  XLA compiles the vmapped ``build_lift_maps`` without the fused
  multiply-adds of the single-view program, so its barycentrics move by
  that bound (up to 7e-5 on the sphere's thinnest faces at 64^2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interactvlm_tpu.geometry import cameras as jc
from interactvlm_tpu.geometry import rasterizer as jr
from interactvlm_tpu.geometry import views as jv
from interactvlm_tpu_torch.geometry import cameras as tc
from interactvlm_tpu_torch.geometry import rasterizer as tr
from interactvlm_tpu_torch.geometry import views as tv

VITRU = jv.HUMAN_VIEWS["4MV-Z_Vitru_mv2"].cam_params()[:4]
ALL_CAMS = np.concatenate(
    [vs.cam_params() for vs in list(jv.HUMAN_VIEWS.values())
     + list(jv.OBJECT_VIEWS.values())])
SPHERE = tr.uv_sphere(83, 84)
_project = jax.jit(jc.project_points, static_argnums=(3,))


def _triangle():
    return (np.array([[-0.5, -0.4, 0.0], [0.6, -0.3, 0.1], [0.0, 0.5, -0.1]],
                     np.float32), np.array([[0, 1, 2]], np.int32))


def _two_triangles():
    """A near triangle over a far one, and a coplanar copy of the far one
    (faces 1 and 2 tie in depth everywhere they overlap: face 1 wins)."""
    near = [[-0.3, -0.3, 0.3], [0.4, -0.2, 0.3], [0.0, 0.4, 0.3]]
    far = [[-0.6, -0.5, -0.2], [0.5, -0.6, -0.2], [0.1, 0.6, -0.2]]
    verts = np.array(near + far, np.float32)
    return verts, np.array([[0, 1, 2], [3, 4, 5], [3, 4, 5]], np.int32)


MESHES = {"triangle": _triangle, "two_triangles": _two_triangles,
          "sphere": lambda: SPHERE}
TRI_CAMS = np.array([[2.0, 0.0, 0.0, 0.0, 0.0], [2.0, 20.0, 30.0, 0.1, -0.2],
                     *VITRU], np.float32)


def _cams(mesh):
    return VITRU if mesh == "sphere" else TRI_CAMS


def test_cameras_match_jax():
    for cp in ALL_CAMS:
        Rj, Tj = jc.camera_from_params(cp)
        Rt, Tt = tc.camera_from_params(cp)
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0,
                                   atol=1e-6)
    R, T = tc.look_at_view_transform(2.0, 90.0, 0.0)  # the nudged pole
    assert torch.isfinite(R).all() and torch.isfinite(T).all()


@pytest.mark.parametrize("size", [64, 1024])
def test_project_points_matches_jax(size):
    verts = SPHERE[0]
    for cp in VITRU:
        Rj, Tj = jc.camera_from_params(cp)
        pj, zj = _project(jnp.asarray(verts), Rj, Tj, size)
        pt, zt = tc.project_points(torch.from_numpy(verts),
                                   *tc.camera_from_params(cp), size)
        # pixels to 1e-6 of the image (NDC units): a few f32 ulps
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                                   atol=1e-6 * size)
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(tc.pixel_centers_ndc(size).numpy(),
                               np.asarray(jc.pixel_centers_ndc(size)),
                               rtol=0, atol=1e-6)


def test_normalize_cam_params_matches_jax():
    got = tv.normalize_cam_params(ALL_CAMS)
    np.testing.assert_allclose(got, jv.normalize_cam_params(ALL_CAMS),
                               rtol=0, atol=1e-6)
    for key, vs in jv.HUMAN_VIEWS.items():
        np.testing.assert_allclose(
            tv.get_human_view_set(key).cam_params(normalized=True),
            vs.cam_params(normalized=True), rtol=0, atol=1e-6)


def test_view_registry_equals_jax():
    for reg_t, reg_j, get in ((tv.HUMAN_VIEWS, jv.HUMAN_VIEWS,
                               tv.get_human_view_set),
                              (tv.OBJECT_VIEWS, jv.OBJECT_VIEWS,
                               tv.get_object_view_set)):
        assert list(reg_t) == list(reg_j)
        for key, vs in reg_j.items():
            got = get(key)
            assert dataclasses.asdict(got) == dataclasses.asdict(vs), key
            assert got.names == vs.names and got.num_views == vs.num_views
    assert tuple(tv.AFFORD_LIST_PIAD) == tuple(jv.AFFORD_LIST_PIAD)
    assert tuple(tv.AFFORD_LIST_LEMON) == tuple(jv.AFFORD_LIST_LEMON)
    assert dict(tv.DAMON_CATEGORIES_MAPPING) == dict(
        jv.DAMON_CATEGORIES_MAPPING)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("size", [64, 128])
def test_zbuffer_on_the_jax_projection_is_exact(mesh, size):
    verts, faces = MESHES[mesh]()
    for cp in _cams(mesh):
        win = jr.pick_window(verts, faces, cp, size)
        fj, bj, zj = jr.rasterize_mesh(jnp.asarray(verts), jnp.asarray(faces),
                                       jnp.asarray(cp), size, win)
        pj, zz = _project(jnp.asarray(verts), *jc.camera_from_params(cp),
                          size)
        ft, bt, zt = tr.rasterize_projected(
            torch.from_numpy(np.array(pj)), torch.from_numpy(np.array(zz)),
            torch.from_numpy(faces), size, win)
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=0,
                                   atol=1e-6)
        # XLA orders the depth's fused sum by the shape it vectorizes: one
        # f32 ulp on the single triangle
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=2 ** -22,
                                   atol=0)
        assert (ft >= 0).any()


def _bary64(pix, faces, p2f):
    """Screen-space barycentrics in f64 of every covered pixel centre in its
    face, from projected vertices ``pix`` (N, 2), and the rounding-error
    bound of computing them in f32: each edge function and the area is a
    2 x 2 determinant a d - b c, whose f32 value (with or without a fused
    multiply-add) is within a few ulps of |a d| + |b c|."""
    ys, xs = np.nonzero(p2f >= 0)
    tri = np.asarray(pix, np.float64)[faces[p2f[ys, xs]]]  # (P, 3, 2)
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]

    def det(o, d, px, py):
        t1 = (d[:, 0] - o[:, 0]) * (py - o[:, 1])
        t2 = (d[:, 1] - o[:, 1]) * (px - o[:, 0])
        return t1 - t2, np.abs(t1) + np.abs(t2)

    w, mag = zip(det(b, c, xs, ys), det(c, a, xs, ys), det(a, b, xs, ys))
    area, area_mag = det(a, b, c[:, 0], c[:, 1])
    bary = np.stack(w, -1) / area[:, None]
    err = 2.0 ** -22 * (np.stack(mag, -1) + np.abs(bary) * area_mag[:, None])
    return (ys, xs), bary, err / np.abs(area)[:, None]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("size", [64, 128])
def test_build_lift_maps_matches_jax(mesh, size):
    verts, faces = MESHES[mesh]()
    cams = _cams(mesh)
    win = max(tr.pick_window(verts, faces, cp, size) for cp in cams)
    assert win == max(jr.pick_window(verts, faces, cp, size) for cp in cams)
    p2v_j, bary_j, p2f_j = (np.asarray(a) for a in jr.build_lift_maps(
        verts, faces, cams, size, win))
    p2v_t, bary_t, p2f_t = (a.numpy() for a in tr.build_lift_maps(
        verts, faces, cams, size, win, device="cpu"))
    flipped = int((p2f_t != p2f_j).sum())
    assert flipped == 0  # no edge or depth tie flips a pixel here
    np.testing.assert_array_equal(p2v_t, p2v_j)
    assert p2v_t.dtype == np.int32 and p2f_t.dtype == np.int32
    # the JAX package's pixels as its vmapped build_lift_maps computes them
    # (cameras traced: XLA rounds them, and the projection, its own way)
    pix_j = jax.jit(jax.vmap(lambda cp: jc.project_points(
        jnp.asarray(verts), *jc.camera_from_params(cp), size)[0]))(
            jnp.asarray(cams))
    for v, cp in enumerate(cams):
        pj = pix_j[v]
        pt, _ = tc.project_points(torch.from_numpy(verts),
                                  *tc.camera_from_params(cp), size)
        at, b_t, err_t = _bary64(pt.numpy(), faces, p2f_t[v])
        _, b_j, err_j = _bary64(np.asarray(pj), faces, p2f_t[v])
        got, want = bary_t[v][at], bary_j[v][at]
        assert np.all(np.abs(got - want)
                      <= 1e-6 + 2 * np.abs(b_t - b_j) + err_t + err_j)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-4)
        assert not bary_t[v][p2f_t[v] < 0].any()


def test_depth_order_and_ties():
    verts, faces = _two_triangles()
    p2f = tr.rasterize_mesh(torch.from_numpy(verts), torch.from_numpy(faces),
                            TRI_CAMS[0], 64, 64)[0].numpy()
    assert (p2f == 0).any() and (p2f == 1).any()  # near over far
    assert not (p2f == 2).any()  # the coplanar copy loses every tie


def test_degenerate_faces_and_meshes_behind_the_camera_hit_nothing():
    verts = np.array([[0, 0, 0], [0.3, 0.1, 0], [0.2, 0.2, 0],
                      [0, 0, 5], [0.3, 0, 5], [0, 0.3, 5]], np.float32)
    faces = np.array([[0, 1, 1], [3, 4, 5]], np.int32)  # no area; behind
    p2f, bary, zbuf = tr.rasterize_mesh(
        torch.from_numpy(verts), torch.from_numpy(faces),
        np.array([2.0, 0.0, 0.0, 0.0, 0.0], np.float32), 32, 8)
    assert (p2f == -1).all() and not bary.any() and torch.isinf(zbuf).all()
    p2v, bary, _ = tr.build_lift_maps(verts, faces, TRI_CAMS[:1], 32, 8,
                                      device="cpu")
    assert (p2v == -1).all() and torch.isfinite(bary).all()


def test_pick_window_matches_jax():
    verts, faces = SPHERE
    for size in (64, 1024):
        for cp in VITRU:
            assert tr.pick_window(verts, faces, cp, size) == jr.pick_window(
                verts, faces, cp, size)


def test_contact_masks_match_jax():
    verts, faces = SPHERE
    rng = np.random.default_rng(3)
    contact = rng.random(len(verts)) < 0.3
    p2f = np.array(jr.rasterize_mesh(jnp.asarray(verts), jnp.asarray(faces),
                                       jnp.asarray(VITRU[0]), 64, 8)[0])
    np.testing.assert_array_equal(
        tr.faces_contact_mask(torch.from_numpy(faces),
                              torch.from_numpy(contact)).numpy(),
        np.asarray(jr.faces_contact_mask(jnp.asarray(faces),
                                         jnp.asarray(contact))))
    got = tr.contact_mask_from_fragments(torch.from_numpy(p2f),
                                         torch.from_numpy(faces),
                                         torch.from_numpy(contact))
    want = jr.contact_mask_from_fragments(jnp.asarray(p2f), jnp.asarray(faces),
                                          jnp.asarray(contact))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


def test_uv_sphere_has_the_smpl_vertex_count_and_closes():
    verts, faces = SPHERE
    assert verts.shape == (6890, 3) and faces.shape == (13776, 3)
    np.testing.assert_allclose(np.linalg.norm(verts, axis=1), 0.8, rtol=1e-6)
    # closed and consistently wound: every directed edge once, and its
    # reverse once
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]])
    as_set = {tuple(e) for e in edges.tolist()}
    assert len(as_set) == len(edges)
    assert all((b, a) in as_set for a, b in as_set)


def test_lift_maps_feed_the_lift():
    """Maps built here, turned corner-major, drive the port's soft lift: a
    contact render of the mesh lifts back onto the contact vertices."""
    from interactvlm_tpu_torch.geometry.lift import (
        corner_major,
        lift_multiview_soft,
    )

    verts, faces = SPHERE
    size = 128
    win = max(tr.pick_window(verts, faces, cp, size) for cp in VITRU)
    p2v, bary, p2f = tr.build_lift_maps(verts, faces, VITRU, size, win,
                                        device="cpu")
    contact = torch.from_numpy(verts[:, 1] > 0.4)  # a cap around the pole
    masks = torch.stack([tr.contact_mask_from_fragments(
        p2f[v], torch.from_numpy(faces), contact) for v in range(4)])
    logits = torch.where(masks, 20.0, -20.0)
    lifted = lift_multiview_soft(logits, corner_major(p2v),
                                 corner_major(bary), len(verts))
    seen = torch.zeros(len(verts), dtype=torch.bool)
    seen[p2v[p2v >= 0].long()] = True
    pred = lifted > 0.5
    tp = (pred & contact & seen).sum().item()
    f1 = 2 * tp / ((pred & seen).sum().item() + (contact & seen).sum().item())
    assert f1 > 0.95
