"""The port's joint human-object fit (``fit/utils.py``, ``renderer.py``,
``icp.py``, ``optimizer.py``, ``fit.py``, ``data_io.py``) against the JAX
package's, on the CPU at tiny sizes: the same numpy inputs through both.

The scene: a 72-vertex human sphere at depth 3 and a 42-vertex ellipsoid
object (its own frame) posed against the human's front left at a seeded
rotation, 32^2 images, OSX intrinsics from a bbox, contacts where the
posed surfaces meet, the target mask the object's hard render at that pose.

Tolerances, with the reason for each:
- helpers, projection, alignment: 1e-6 (f32 rounding of a few operations;
  XLA's dot sums in another order than torch's matmul);
- the soft silhouette: values within 1e-5, vertex gradients within 1e-4 of
  the largest (the per-pixel sums of up to hundreds of log terms and their
  backward, in another order);
- the hard renderers: winner faces, hit masks and depths exact (the port
  rounds the edge functions, areas and depths as XLA's compiled code does,
  ``geometry/rasterizer.py:_cross``), shading within 1e-5;
- nearest neighbours: equal, on points whose distances are at least 1e-3
  apart (the expanded-norm distances round differently on the two sides);
- ICP: the rmse within 1e-5, the transform and points within 1e-4 (ten-odd
  iterations of f32 SVDs);
- losses: 1e-5 relative; the fit loops (``run_fit``, ``fit_human_object``,
  the CLI): losses within 1e-4 relative and parameters within 1e-4, over 12
  Adam steps. Adam's first step is lr * sign(g): the scene is asymmetric
  and the start rotation generic, so that every gradient component is far
  above its rounding and no sign comes from rounding.

The half-gradient rule (``jnp.clip`` and ``jnp.maximum`` give half the
gradient on a bound, ``torch.clamp`` all of it) is the port's, through
``geometry/lift.py:clip`` and ``fit/utils.py:_floor``. In the soft
silhouette the clamp of the segment parameter t is hit exactly at
integer-coordinate scenes; there the distance's derivative in t is zero
(the foot of the perpendicular is the segment's end), so the gradient is
the same under either rule: the test checks the bound is hit and the
gradient equals JAX's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from interactvlm_tpu.fit import data_io as JD
from interactvlm_tpu.fit import fit as JF
from interactvlm_tpu.fit import icp as JI
from interactvlm_tpu.fit import optimizer as JO
from interactvlm_tpu.fit import renderer as JR
from interactvlm_tpu.fit import utils as JU
from interactvlm_tpu_torch.fit import data_io as TD
from interactvlm_tpu_torch.fit import fit as TF
from interactvlm_tpu_torch.fit import icp as TI
from interactvlm_tpu_torch.fit import optimizer as TO
from interactvlm_tpu_torch.fit import renderer as TR
from interactvlm_tpu_torch.fit import utils as TU
from interactvlm_tpu_torch.geometry.lift import clip
from interactvlm_tpu_torch.geometry.rasterizer import uv_sphere

S, STEPS = 32, 12
BBOX = np.array([15.2, 14.9, 1.536, 2.048], np.float32)  # focal ~ 40 px
WEIGHTS = dict(contact_kick_in=5)  # the contact loss from step 5


def t(x):
    return torch.as_tensor(np.array(x))


def random_rotation(seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.astype(np.float32)


def outward(verts, faces):
    """A UV sphere with its faces wound outward (``uv_sphere`` winds them
    inward), as a body or object mesh is wound."""
    return verts, np.ascontiguousarray(faces[:, ::-1])


def make_scene(seed=0):
    """The tiny scene dict ``fit_human_object`` takes, and the object's
    true pose (R, center)."""
    hv, hf = outward(*uv_sphere(8, 10, 0.8))
    hc = np.array([0.05, -0.1, 3.0], np.float32)
    hv = hv + hc
    ov, of = outward(*uv_sphere(6, 8, 1.0))
    ov = (ov * np.array([0.35, 0.22, 0.28], np.float32)).astype(np.float32)
    R = random_rotation(seed)
    d = np.array([0.55, 0.25, -0.8], np.float32)
    center = hc + d / np.linalg.norm(d) * 1.0
    posed = (ov @ R.T + center).astype(np.float32)
    do = np.linalg.norm(posed[:, None] - hv[None], axis=-1)
    focal, princpt = JD.camera_from_bbox(BBOX, (S, S))
    mask = np.isfinite(np.asarray(JR.render_depth(
        jnp.asarray(posed), jnp.asarray(of), jnp.asarray(focal),
        jnp.asarray(princpt), S))).astype(np.float32)
    scene = {
        "obj_verts": ov, "obj_faces": of, "hum_verts": hv, "hum_faces": hf,
        "obj_contact_probs": np.where(do.min(1) < 0.3, 0.9, 0.05
                                      ).astype(np.float32),
        "hum_contact_probs": np.where(do.min(0) < 0.35, 0.9, 0.05
                                      ).astype(np.float32),
        "target_mask": mask, "focal": focal, "princpt": princpt,
        "centroid_offset": np.zeros(3, np.float32),
    }
    return scene, R, center


@pytest.fixture(scope="module")
def scene():
    sc, R, center = make_scene()
    assert (sc["obj_contact_probs"] > 0.5).sum() >= 4
    assert (sc["hum_contact_probs"] > 0.5).sum() >= 4
    assert 10 < sc["target_mask"].sum() < S * S / 2
    return sc


def posed_object(scene):
    sc, R, center = make_scene()
    return (sc["obj_verts"] @ R.T + center).astype(np.float32)


def close(got, want, rtol=1e-6, atol=1e-6):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


# ------------------------------------------------------------- helpers
def test_rotation_and_transform_helpers_match_jax():
    rng = np.random.default_rng(1)
    r6 = rng.normal(size=(5, 6)).astype(np.float32)
    close(TU.rot6d_to_matrix(t(r6)), JU.rot6d_to_matrix(jnp.asarray(r6)))
    R = random_rotation(2)
    close(TU.matrix_to_rot6d(t(R)), JU.matrix_to_rot6d(jnp.asarray(R)))
    # the gradient through the Gram-Schmidt
    W = rng.normal(size=(5, 3, 3)).astype(np.float32)
    jg = jax.grad(lambda r: (JU.rot6d_to_matrix(r) * W).sum())(
        jnp.asarray(r6))
    tr6 = t(r6).requires_grad_()
    (TU.rot6d_to_matrix(tr6) * t(W)).sum().backward()
    close(tr6.grad, jg, atol=1e-5)
    v = rng.normal(size=(7, 3)).astype(np.float32)
    for scale in (None, 1.7):
        close(TU.apply_transformation(t(v), t(r6[0]), t([1.0, 2.0, 3.0]),
                                      scale),
              JU.apply_transformation(jnp.asarray(v), jnp.asarray(r6[0]),
                                      jnp.asarray([1.0, 2.0, 3.0]), scale),
              atol=1e-5)
    m = rng.random((9, 13)).astype(np.float32)
    close(TU.calculate_centroid(t(m)), JU.calculate_centroid(jnp.asarray(m)))
    close(TU.normalized_distance(t([1.0, 2.0]), t([4.0, 6.5]), (9, 13)),
          JU.normalized_distance(jnp.asarray([1.0, 2.0]),
                                 jnp.asarray([4.0, 6.5]), (9, 13)))
    hv, hf = uv_sphere(8, 10, 0.8)
    close(TU.compute_vertex_normals(t(hv), t(hf)),
          JU.compute_vertex_normals(jnp.asarray(hv), jnp.asarray(hf)))
    close(TR.vertex_normals(t(hv), t(hf)),
          JR.vertex_normals(jnp.asarray(hv), jnp.asarray(hf)))


def test_project_perspective_matches_jax(scene):
    v = np.concatenate([scene["hum_verts"], [[0.1, 0.2, 0.0]]]
                       ).astype(np.float32)  # one vertex on the camera plane
    for flip in (True, False):
        jxy, jz = JR.project_perspective(jnp.asarray(v), scene["focal"],
                                         scene["princpt"], flip)
        txy, tz = TR.project_perspective(t(v), scene["focal"],
                                         scene["princpt"], flip)
        np.testing.assert_array_equal(txy.numpy(), np.asarray(jxy))
        np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))


# ------------------------------------------------------------ renderers
def _degenerate(v, f):
    """The mesh plus a zero-area face (its three corners on a line)."""
    v = np.concatenate([v, [v[0], (v[0] + v[1]) / 2, v[1]]]).astype(
        np.float32)
    n = len(v)
    return v, np.concatenate([f, [[n - 3, n - 2, n - 1]]]).astype(np.int32)


def render_inputs(scene, which):
    v, f = posed_object(scene), scene["obj_faces"]
    if which == "degenerate":
        v, f = _degenerate(v, f)
    elif which == "two_objects":  # a second copy behind, and a duplicate
        far = v + np.array([0.05, 0.02, 0.4], np.float32)
        f = np.concatenate([f, f + len(v), f[:3]]).astype(np.int32)
        v = np.concatenate([v, far]).astype(np.float32)
    return v, f


@pytest.mark.parametrize("which", ["ellipsoid", "degenerate", "two_objects"])
def test_soft_silhouette_values_and_gradients_match_jax(scene, which):
    v, f = render_inputs(scene, which)
    W = np.random.default_rng(2).normal(size=(S, S)).astype(np.float32)

    def jloss(vv):
        return (JR.render_silhouette(vv, jnp.asarray(f), scene["focal"],
                                     scene["princpt"], S) * W).sum()

    jsil = JR.render_silhouette(jnp.asarray(v), jnp.asarray(f),
                                scene["focal"], scene["princpt"], S)
    jg = jax.grad(jloss)(jnp.asarray(v))
    tv = t(v).requires_grad_()
    tsil = TR.render_silhouette(tv, t(f), scene["focal"], scene["princpt"], S)
    (tsil * t(W)).sum().backward()
    close(tsil, jsil, rtol=0, atol=1e-5)
    assert 0.05 < float(tsil.detach().mean()) < 0.9
    jg = np.asarray(jg)
    close(tv.grad, jg, rtol=0, atol=1e-4 * np.abs(jg).max())


def test_silhouette_gradient_at_the_clamp_bound_matches_jax():
    """Triangles with integer pixel coordinates: the segment parameter t
    of many candidates is exactly 0 or 1. The gradient in the projected
    vertices equals JAX's; and ``lift.clip`` gives half the gradient on a
    bound, as ``jnp.clip`` does."""
    xy = np.array([[4, 4], [12, 4], [8, 12], [20, 6], [26, 6], [20, 14]],
                  np.float32)
    z = np.full(6, 2.0, np.float32)
    f = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    # candidates whose t is exactly 0 or 1 on some edge
    px, py = np.meshgrid(np.arange(S), np.arange(S))
    p = np.stack([px, py], -1).reshape(-1, 2).astype(np.float32)
    hits = 0
    for tri in xy[f]:
        for a, b in ((tri[0], tri[1]), (tri[1], tri[2]), (tri[2], tri[0])):
            tt = ((p - a) * (b - a)).sum(-1) / ((b - a) ** 2).sum()
            hits += int(((tt == 0) | (tt == 1)).sum())
    assert hits > 20
    W = np.random.default_rng(3).normal(size=(S, S)).astype(np.float32)
    jg = jax.grad(lambda q: (JR.soft_silhouette(
        q, jnp.asarray(z), jnp.asarray(f), S) * W).sum())(jnp.asarray(xy))
    tq = t(xy).requires_grad_()
    (TR.soft_silhouette(tq, t(z), t(f), S) * t(W)).sum().backward()
    close(tq.grad, jg, rtol=1e-5, atol=1e-5)
    x = torch.tensor([0.0, 1.0, 0.5], requires_grad=True)
    clip(x, 0.0, 1.0).sum().backward()
    jx = jax.grad(lambda a: jnp.clip(a, 0.0, 1.0).sum())(
        jnp.asarray([0.0, 1.0, 0.5]))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jx))
    assert x.grad.tolist() == [0.5, 0.5, 1.0]


@pytest.mark.parametrize("which", ["ellipsoid", "degenerate", "two_objects"])
def test_hard_renderers_match_jax(scene, which):
    v, f = render_inputs(scene, which)
    args = (scene["focal"], scene["princpt"], S)
    jxy, jz = JR.project_perspective(jnp.asarray(v), *args[:2])
    jw, jzb = jax.jit(JR._rasterize_winner, static_argnums=(3, 4))(
        jxy, jz, jnp.asarray(f), S, 16)
    txy, tz = TR.project_perspective(t(v), *args[:2])
    tw, tzb = TR._rasterize_winner(txy, tz, t(f), S, 16)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tzb.numpy(), np.asarray(jzb))
    assert (tw.numpy() < len(f)).sum() > 10
    jrgba = np.asarray(JR.render_phong(jnp.asarray(v), jnp.asarray(f), *args))
    trgba = TR.render_phong(t(v), t(f), *args).numpy()
    np.testing.assert_array_equal(trgba[..., 3], jrgba[..., 3])
    close(trgba, jrgba, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        TR.render_depth(t(v), t(f), *args).numpy(),
        np.asarray(JR.render_depth(jnp.asarray(v), jnp.asarray(f), *args)))


# ------------------------------------------------------------------ ICP
@pytest.mark.parametrize("estimate_scale", [False, True])
@pytest.mark.parametrize("weights", ["none", "random", "zeros"])
def test_alignment_matches_jax(estimate_scale, weights):
    """Umeyama on clouds whose covariance has well-separated singular
    values (R is unique); with all weights 0 the total is eps."""
    rng = np.random.default_rng(4)
    X = (rng.normal(size=(40, 3)) * [1.0, 0.5, 0.2]).astype(np.float32)
    Y = (1.3 * X @ random_rotation(5) + [0.3, -0.2, 0.5]
         + rng.normal(scale=0.01, size=X.shape)).astype(np.float32)
    w = {"none": None, "random": rng.random(40).astype(np.float32),
         "zeros": np.zeros(40, np.float32)}[weights]
    want = JI.corresponding_points_alignment(
        jnp.asarray(X), jnp.asarray(Y),
        None if w is None else jnp.asarray(w), estimate_scale)
    got = TI.corresponding_points_alignment(
        t(X), t(Y), None if w is None else t(w), estimate_scale)
    for g, j in zip(got, want):
        close(g, j, atol=1e-5, rtol=1e-5)
    if weights == "zeros":
        close(got.R, np.eye(3))
        assert float(got.s) == (0.0 if estimate_scale else 1.0)


def test_nearest_neighbors_match_jax():
    rng = np.random.default_rng(6)
    q = rng.normal(size=(50, 6)).astype(np.float32)
    r = rng.normal(size=(80, 6)).astype(np.float32)
    d = np.sort(((q[:, None].astype(np.float64) - r[None]) ** 2).sum(-1), 1)
    assert (d[:, 1] - d[:, 0]).min() > 1e-3  # distinct nearest distances
    got = TI.nearest_neighbors(t(q), t(r))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        JI.nearest_neighbors(jnp.asarray(q), jnp.asarray(r))))


@pytest.mark.parametrize("estimate_scale", [False, True])
def test_icp_with_normals_and_weights_matches_jax(scene, estimate_scale):
    ov = scene["obj_verts"] + np.array([0.6, 0.15, 2.3], np.float32)
    args = [ov, scene["obj_faces"], scene["hum_verts"], scene["hum_faces"],
            scene["obj_contact_probs"], scene["hum_contact_probs"]]
    want = JF.icp_init(*map(jnp.asarray, args), estimate_scale=estimate_scale)
    got = TF.icp_init(*map(t, args), estimate_scale=estimate_scale)
    assert bool(got.converged) == bool(want.converged)
    close(got.rmse, want.rmse, atol=1e-5, rtol=1e-5)
    close(got.Xt, want.Xt, atol=1e-4, rtol=0)
    for g, j in zip(got.RTs, want.RTs):
        close(g, j, atol=1e-4, rtol=0)
    # without normals or weights, from an initial transform
    init = JI.SimilarityTransform(jnp.eye(3), jnp.zeros(3), jnp.ones(()))
    want = JI.icp(jnp.asarray(ov), jnp.asarray(scene["hum_verts"]),
                  init_transform=init, max_iterations=20, min_scale=0.5)
    got = TI.icp(t(ov), t(scene["hum_verts"]),
                 init_transform=TI.SimilarityTransform(
                     torch.eye(3), torch.zeros(3), torch.ones(())),
                 max_iterations=20, min_scale=0.5)
    close(got.rmse, want.rmse, atol=1e-5, rtol=1e-5)
    close(got.Xt, want.Xt, atol=1e-4, rtol=0)


# --------------------------------------------------------------- losses
def _jscene(sc):
    return {k: jnp.asarray(v) for k, v in sc.items()}


def _tscene(sc):
    return {k: t(v) for k, v in sc.items()}


def start_params(scene, seed=7):
    """A generic start: a seeded rotation, the translation off the truth."""
    R = random_rotation(seed)
    return (np.concatenate([R[0], R[1]]).astype(np.float32),
            np.array([0.75, 0.2, 2.45], np.float32), np.float32(0.1))


def test_losses_match_jax(scene):
    rng = np.random.default_rng(8)
    o = rng.normal(size=(9, 3)).astype(np.float32)
    h = rng.normal(size=(11, 3)).astype(np.float32)
    op, hp = rng.random(9).astype(np.float32), rng.random(11).astype(
        np.float32)
    close(TO.contact_loss(t(o), t(h), t(op), t(hp)),
          JO.contact_loss(*map(jnp.asarray, (o, h, op, hp))), rtol=1e-5)
    a, b = rng.random((2, 8, 8)).astype(np.float32)
    close(TO.mask_iou_loss(t(a), t(b)),
          JO.mask_iou_loss(jnp.asarray(a), jnp.asarray(b)), rtol=1e-5)

    sc = dict(scene, target_centroid=np.asarray(JU.calculate_centroid(
        jnp.asarray(scene["target_mask"]))))
    r6, tr, ls = start_params(scene)
    for kw, steps in ((WEIGHTS, (4, 5)), (dict(mask_kick_in=-1,
                                               centroid_kick_in=3), (2, 3))):
        w = JO.LossWeights(**kw)
        for step in steps:
            def jtotal(p):
                return JO.fit_losses(p, jnp.int32(step), _jscene(sc), w, S,
                                     1.0, 16)
            jp = JO.FitParams(jnp.asarray(r6), jnp.asarray(tr),
                              jnp.asarray(ls))
            (jt, jparts), jg = jax.value_and_grad(jtotal, has_aux=True)(jp)
            tp = TO.FitParams(*(t(x).requires_grad_() for x in (r6, tr, ls)))
            tt, tparts = TO.fit_losses(tp, step, _tscene(sc),
                                       TO.LossWeights(**kw), S, 1.0, 16)
            tt.backward()
            close(tt, jt, rtol=1e-5, atol=1e-7)
            for k in jparts:
                close(tparts[k], jparts[k], rtol=1e-5, atol=1e-7)
            for g, j in zip(tp, jg):
                close(g.grad, j, rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------ fit loops
@pytest.mark.parametrize("optimize_scale", [True, False])
def test_run_fit_matches_jax(scene, optimize_scale):
    """12 steps with the contact loss kicking in at 5: the histories, the
    best iterate (one step late: the parameters after the update of the
    step whose loss, taken before it, was lowest) and a fixed scale when
    the scale is not optimised."""
    sc = dict(scene, target_centroid=np.asarray(JU.calculate_centroid(
        jnp.asarray(scene["target_mask"]))))
    r6, tr, ls = start_params(scene)
    jbest, jloss, jhist, jph = JO.run_fit(
        JO.FitParams(jnp.asarray(r6), jnp.asarray(tr), jnp.asarray(ls)),
        _jscene(sc), JO.LossWeights(**WEIGHTS), num_steps=STEPS,
        image_size=S, optimize_scale=optimize_scale)
    tbest, tloss, thist, tph = TO.run_fit(
        TO.FitParams(t(r6), t(tr), t(ls)), _tscene(sc),
        TO.LossWeights(**WEIGHTS), num_steps=STEPS, image_size=S,
        optimize_scale=optimize_scale)
    close(thist, jhist, rtol=1e-4, atol=1e-6)
    close(tloss, jloss, rtol=1e-4, atol=1e-6)
    for g, j in zip(tph, jph):
        close(g, j, rtol=0, atol=1e-4)
    for g, j in zip(tbest, jbest):
        close(g, j, rtol=0, atol=1e-4)
    k = int(np.argmin(thist.numpy()))
    assert k > 0 and float(tloss) == float(thist[k])
    for g, h in zip(tbest, tph):
        np.testing.assert_array_equal(g.numpy(), h[k].numpy())
    # ... not the parameters the lowest loss was taken at
    assert not torch.equal(tbest.rot6d, tph.rot6d[k - 1])
    assert not torch.equal(tbest.translation, tph.translation[k - 1])
    moved = tph.log_scale - float(ls)
    assert (moved.abs().max() == 0) == (not optimize_scale)
    # the contact loss enters at step 5
    assert not np.allclose(np.diff(thist.numpy())[4], 0.0)


def test_fit_human_object_and_video_match_jax(scene, tmp_path):
    jbest, jdiag = JF.fit_human_object(scene, JO.LossWeights(**WEIGHTS),
                                       num_steps=STEPS, image_size=S)
    video = str(tmp_path / "fit.gif")
    tbest, tdiag = TF.fit_human_object(
        scene, TO.LossWeights(**WEIGHTS), num_steps=STEPS, image_size=S,
        video_path=video, video_every=5, device="cpu")
    for g, j in zip(tdiag["init_params"], jdiag["init_params"]):
        close(g, j, rtol=0, atol=1e-4)
    close(tdiag["loss_history"], jdiag["loss_history"], rtol=1e-4, atol=1e-6)
    for g, j in zip(tbest, jbest):
        close(g, j, rtol=0, atol=1e-4)
    with Image.open(video) as im:
        assert im.n_frames == 4  # steps 0, 5, 10 and the last, 11
        assert im.size == (S, S)


# -------------------------------------------------------------- data IO
def write_fit_folder(d, scene):
    """The folder layout ``load_fit_inputs`` reads, from a scene: the
    object mesh with y and z flipped (the loader flips them back)."""
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, "human.npz"), smpl_vertices=scene["hum_verts"],
             smpl_faces=scene["hum_faces"], bbox=BBOX)
    JD.save_obj_mesh(os.path.join(d, "object_mesh.obj"),
                     scene["obj_verts"] * np.array([1, -1, -1], np.float32),
                     scene["obj_faces"])
    np.savez(os.path.join(d, "hcontact.npz"),
             contact=scene["hum_contact_probs"])
    np.savez(os.path.join(d, "ocontact.npz"),
             contact=scene["obj_contact_probs"])
    np.save(os.path.join(d, "object_mask.npy"), scene["target_mask"])


def test_data_io_matches_jax(scene, tmp_path):
    rng = np.random.default_rng(9)
    colors = rng.random((len(scene["obj_verts"]), 3))
    for name, mod in (("jax", JD), ("port", TD)):
        mod.save_obj_mesh(str(tmp_path / f"{name}.obj"), scene["obj_verts"],
                          scene["obj_faces"], colors)
    text = (tmp_path / "port.obj").read_text()
    assert text == (tmp_path / "jax.obj").read_text()
    (tmp_path / "quad.obj").write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1/1 2/2 3/3 4/4\n")
    for path in (tmp_path / "port.obj", tmp_path / "quad.obj"):
        for g, j in zip(TD.load_obj_mesh(str(path)),
                        JD.load_obj_mesh(str(path))):
            np.testing.assert_array_equal(g, j)
            assert g.dtype == j.dtype
    for g, j in zip(TD.camera_from_bbox(BBOX, (S, S)),
                    JD.camera_from_bbox(BBOX, (S, S))):
        np.testing.assert_array_equal(g, j)
    write_fit_folder(str(tmp_path / "sample"), scene)
    got = TD.load_fit_inputs(str(tmp_path / "sample"))
    want = JD.load_fit_inputs(str(tmp_path / "sample"))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    close(got["obj_verts"], scene["obj_verts"])


def test_fit_cli_matches_jax(scene, tmp_path):
    d = str(tmp_path / "sample")
    write_fit_folder(d, scene)
    common = ["--input_path", d, "--num_steps", str(STEPS), "--image_size",
              str(S)]
    JD.main(common + ["--output_path", str(tmp_path / "jax")])
    TD.main(common + ["--output_path", str(tmp_path / "port"), "--device",
                      "cpu", "--save_video"])
    want = np.load(tmp_path / "jax" / "fit_result.npz")
    got = np.load(tmp_path / "port" / "fit_result.npz")
    assert got.files == want.files
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    for name in ("final_object.obj", "final_human.obj"):
        gv, gf = TD.load_obj_mesh(str(tmp_path / "port" / name))
        jv, jf = JD.load_obj_mesh(str(tmp_path / "jax" / name))
        np.testing.assert_array_equal(gf, jf)
        np.testing.assert_allclose(gv, jv, atol=1e-4)
    assert (tmp_path / "port" / "fit_trajectory.gif").exists()
