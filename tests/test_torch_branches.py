"""The port's interaction heads and the pieces under them against the JAX
package, each alone on the same weights (carried by ``from_jax_params`` and
its per-Dense helpers) and the same numpy inputs from a seed: the
``view_index`` and ``vi_v1`` cam encoders, the attention splitter, the
fusion (also at Lq >= 512, the shape that reaches the flash kernel on the
card; the CPU runs the plain attention there), the uncertainty head, the
prompt encoder's point, box and mask prompts, the DifDe decoders by domain,
``postprocess_masks`` scaling up and down, the per-sample object lifts and
``lift_object``, ``condition_views`` for every token type and cam encoder,
and ``seg_embeddings_k``.

Tolerances (f32 on the CPU on both sides, differing in summation order):
head outputs and prompt embeddings within 1e-5 absolute and relative; mask
logits within 1e-4 absolute and relative; contacts and lifts within 1e-5.
"""

import dataclasses

import flax.linen as nn
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from interactvlm_tpu.config import interactvlm_tiny as jax_tiny
from interactvlm_tpu.config import sam_tiny as jax_sam_tiny
from interactvlm_tpu.geometry import lift as jax_lift
from interactvlm_tpu.models import components as JC
from interactvlm_tpu.models.interactvlm import InteractVLM as JaxIVLM
from interactvlm_tpu.models.interactvlm import lift_object as jax_lift_object
from interactvlm_tpu.models.sam.sam import Sam as JaxSam
from interactvlm_tpu.models.sam.sam import postprocess_masks as jax_postprocess
from interactvlm_tpu_torch.config import interactvlm_tiny, sam_tiny
from interactvlm_tpu_torch.geometry import lift
from interactvlm_tpu_torch.models import components as C
from interactvlm_tpu_torch.models.interactvlm import InteractVLM, lift_object
from interactvlm_tpu_torch.models.sam.sam import Sam, postprocess_masks
from interactvlm_tpu_torch.utils import weights as W

HEAD_TOL, MASK_TOL, LIFT_TOL = 1e-5, 1e-4, 1e-5
HSEG, OSEG = 501, 502


def _np(tree):
    return jax.tree.map(np.array, nn.meta.unbox(tree))


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _port_module(module, params):
    """Load a flax module's Dense leaves into its port twin by name."""
    sd = {}
    for name, node in params["params"].items():
        W._dense(node, f"{name}.", sd)
    missing, unexpected = module.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    return module


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


# ------------------------------------------------------------------ heads
CAM_ENCODERS = {
    "view_index": (lambda: JC.ViewIndexCamPoseEncoder(4, 32),
                   lambda: C.ViewIndexCamPoseEncoder(4, 32, torch.float32,
                                                     "cpu")),
    "vi_v1": (lambda: JC.VIv1CamPoseEncoder(4, output_dim=32),
              lambda: C.VIv1CamPoseEncoder(4, 32, torch.float32, "cpu")),
}


@pytest.mark.parametrize("kind", sorted(CAM_ENCODERS))
def test_cam_encoders_match_jax(kind):
    jax_build, port_build = CAM_ENCODERS[kind]
    cams = _rng(0).random((3, 4, 5)).astype(np.float32)
    jm = jax_build()
    params = _np(jm.init(jax.random.PRNGKey(1), jnp.asarray(cams)))
    tm = _port_module(port_build(), params)
    want = jm.apply(params, jnp.asarray(cams))
    got = tm(torch.from_numpy(cams))
    assert got.shape == (3, 4, 32)
    _close(got, want, HEAD_TOL)
    # head v sees view v only: a change to view 0 leaves the others
    cams2 = cams.copy()
    cams2[:, 0] += 1.0
    got2 = tm(torch.from_numpy(cams2))
    assert torch.equal(got2[:, 1:], got[:, 1:])
    assert not torch.equal(got2[:, 0], got[:, 0])


def test_attention_splitter_matches_jax():
    x = _normal(_rng(1), (3, 4, 32))
    jm = JC.AttentionSplitter(32)
    params = _np(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    assert "output_proj" in params["params"]  # one projection, shared
    tm = _port_module(C.AttentionSplitter(32, torch.float32, "cpu"), params)
    wh, wo = jm.apply(params, jnp.asarray(x))
    gh, go = tm(torch.from_numpy(x))
    _close(gh, wh, HEAD_TOL)
    _close(go, wo, HEAD_TOL)
    assert not torch.allclose(gh, go)


@pytest.mark.parametrize("g,Lk", [(4, 12), (24, 40)],
                         ids=["tiny", "Lq576-kernel-shape"])
def test_fusion_matches_jax(g, Lk):
    rng = _rng(g)
    sam = _normal(rng, (2, g, g, 32))
    llava = _normal(rng, (2, Lk, 64))
    jm = JC.LLaVASAMFusion(32, 64)
    params = _np(jm.init(jax.random.PRNGKey(3), jnp.asarray(sam),
                         jnp.asarray(llava)))
    tm = _port_module(C.LLaVASAMFusion(32, 64, torch.float32, "cpu"), params)
    want = jm.apply(params, jnp.asarray(sam), jnp.asarray(llava))
    got = tm(torch.from_numpy(sam), torch.from_numpy(llava))
    _close(got, want, HEAD_TOL)
    assert (got - torch.from_numpy(sam)).abs().max() > 1e-3  # it fused


def test_uncertainty_matches_jax():
    x = _normal(_rng(4), (2, 4, 4, 32))
    jm = JC.UncertaintyModule()
    params = _np(jm.init(jax.random.PRNGKey(4), jnp.asarray(x)))
    tm = _port_module(C.UncertaintyModule(32, torch.float32, "cpu"), params)
    got = tm(torch.from_numpy(x))
    assert got.shape == (2, 4, 4, 1) and bool((got > 0).all())
    _close(got, jm.apply(params, jnp.asarray(x)), HEAD_TOL)


# ------------------------------------------------------------------ SAM
@pytest.fixture(scope="module")
def difde_sam():
    """A DifDe SAM whose tree also holds the mask-downscaling convolutions
    (initialised through a mask prompt)."""
    rng = _rng(5)
    jcfg, tcfg = jax_sam_tiny(), sam_tiny()
    g = jcfg.image_embedding_size
    px = _normal(rng, (2, 64, 64, 3))
    txt = _normal(rng, (2, 3, 32))
    masks = _normal(rng, (2, 4 * g, 4 * g, 1))
    jm = JaxSam(jcfg, use_diff_decoder=True)

    def init(m, px, txt, masks):
        out = m.init_all(px, txt)
        m.prompt_encoder(text_embeds=txt, masks=masks)
        return out

    params = _np(jm.init(jax.random.PRNGKey(6), jnp.asarray(px),
                         jnp.asarray(txt), jnp.asarray(masks), method=init))
    tm = Sam(tcfg, device="cpu", use_diff_decoder=True)
    missing, unexpected = tm.load_state_dict(
        W.from_jax_params(params["params"]), strict=False)
    assert not missing and not unexpected
    return jm, params, tm, rng


PROMPTS = {
    "points": dict(points=True),
    "points+boxes": dict(points=True, boxes=True),
    "boxes": dict(boxes=True),
    "mask+text": dict(masks=True, text=True),
    "points+boxes+text": dict(points=True, boxes=True, text=True),
}


@pytest.mark.parametrize("kind", sorted(PROMPTS))
def test_prompt_encoder_prompts_match_jax(difde_sam, kind):
    jm, params, tm, _ = difde_sam
    rng = _rng(len(kind))
    want_kw = PROMPTS[kind]
    g = tm.config.image_embedding_size
    args = {}
    if want_kw.get("points"):
        args["points"] = (rng.random((2, 3, 2)) * 64).astype(np.float32)
        args["point_labels"] = np.array([[1, 0, -1], [0, 1, 1]], np.int32)
    if want_kw.get("boxes"):
        args["boxes"] = (rng.random((2, 4)) * 64).astype(np.float32)
    if want_kw.get("masks"):
        args["masks"] = _normal(rng, (2, 4 * g, 4 * g, 1))
    if want_kw.get("text"):
        args["text_embeds"] = _normal(rng, (2, 2, 32))
    js, jd = jm.apply(params, method=lambda m: m.prompt_encoder(
        **{k: jnp.asarray(v) for k, v in args.items()}))
    with torch.inference_mode():
        ts, td = tm.prompt_encoder(**{k: torch.from_numpy(v)
                                      for k, v in args.items()})
    assert ts.shape == js.shape and td.shape == jd.shape
    _close(ts, js, HEAD_TOL)
    _close(td, jd, HEAD_TOL)
    if "points" in args and "boxes" not in args:  # the padding point
        assert ts.shape[1] == args["points"].shape[1] + 1


def test_prompt_encoder_needs_a_prompt(difde_sam):
    with pytest.raises(ValueError, match="prompt"):
        difde_sam[2].prompt_encoder()


def test_difde_decode_masks_by_domain_match_jax(difde_sam):
    jm, params, tm, rng = difde_sam
    g = tm.config.image_embedding_size
    emb = _normal(rng, (3, g, g, 32))
    txt = _normal(rng, (3, 4, 32))
    got = {}
    for domain in (None, "hcontact", "oafford", "ocontact", "h2dcontact"):
        want, wiou = jm.apply(params, jnp.asarray(emb), jnp.asarray(txt),
                              domain, method=JaxSam.decode_masks)
        with torch.inference_mode():
            low, iou = tm.decode_masks(torch.from_numpy(emb),
                                       torch.from_numpy(txt), domain)
        _close(low, want, MASK_TOL)
        _close(iou, wiou, MASK_TOL)
        got[domain] = low
    # three decoders: oafford and ocontact share the object one, a 2D
    # domain takes the default one
    assert torch.equal(got["oafford"], got["ocontact"])
    assert torch.equal(got["h2dcontact"], got[None])
    assert not torch.allclose(got["hcontact"], got[None])
    assert not torch.allclose(got["ocontact"], got[None])


@pytest.mark.parametrize("original", [(96, 80), (30, 25), (96, 25), (48, 40)],
                         ids=["up", "down", "up-and-down", "same"])
def test_postprocess_masks_matches_jax(original):
    low = _normal(_rng(7), (2, 1, 16, 16), 4.0)
    want = jax_postprocess(jnp.asarray(low), 64, (48, 40), original)
    got = postprocess_masks(torch.from_numpy(low), 64, (48, 40), original)
    assert got.shape == (2, 1) + original
    _close(got, want, MASK_TOL)


# ------------------------------------------------------------------ lifts
def _maps(rng, lead, hw, n, invalid=-1):
    p2v = rng.integers(invalid, n, lead + (hw, hw, 3)).astype(np.int32)
    bary = rng.dirichlet([1, 1, 1], lead + (hw, hw)).astype(np.float32)
    return lift.corner_major(p2v), lift.corner_major(bary)


def test_object_lifts_match_jax():
    rng = _rng(8)
    V, hw, N, P = 4, 16, 40, 24
    logits = _normal(rng, (V, hw, hw), 3.0)
    p2v3, bary3 = _maps(rng, (V,), hw, N)
    want = jax_lift.lift_multiview_thresholded(
        jnp.asarray(logits), jnp.asarray(p2v3), jnp.asarray(bary3), N)
    got = lift.lift_multiview_thresholded(
        torch.from_numpy(logits), torch.from_numpy(p2v3),
        torch.from_numpy(bary3), N)
    _close(got, want, LIFT_TOL)
    assert float(got.max()) > 0.3  # only pixels above the threshold vote
    values = rng.random((V, hw, hw)).astype(np.float32)
    p2p = rng.integers(-1, P, (V, hw, hw)).astype(np.int32)
    want = jax_lift.lift_multiview_points(jnp.asarray(values),
                                          jnp.asarray(p2p), P)
    got = lift.lift_multiview_points(torch.from_numpy(values),
                                     torch.from_numpy(p2p), P)
    _close(got, want, LIFT_TOL)
    masks = _normal(rng, (3, V, hw, hw), 3.0)
    _close(lift_object(torch.from_numpy(masks), torch.from_numpy(p2v3),
                       torch.from_numpy(bary3), N),
           jax_lift_object(jnp.asarray(masks), jnp.asarray(p2v3),
                           jnp.asarray(bary3), N), LIFT_TOL)


def test_thresholded_lift_gradient_skips_the_selection():
    """The threshold's selection carries no gradient: the logits' gradient
    is the probabilities' alone, as in JAX."""
    rng = _rng(9)
    V, hw, N = 2, 8, 12
    logits = _normal(rng, (V, hw, hw), 3.0)
    p2v3, bary3 = _maps(rng, (V,), hw, N)
    want = jax.grad(lambda x: jax_lift.lift_multiview_thresholded(
        x, jnp.asarray(p2v3), jnp.asarray(bary3), N).sum())(
            jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    lift.lift_multiview_thresholded(x, torch.from_numpy(p2v3),
                                    torch.from_numpy(bary3), N).sum().backward()
    _close(x.grad, want, LIFT_TOL)


# ------------------------------------------------------------------ composite
COND_CASES = [(tt, ce) for tt in ("Gen", "Gen-Hu-Obj", "Gen-Int")
              for ce in ("simple", "view_index", "vi_v1")]


def _cfg_kw(token_type, cam):
    oseg = HSEG if token_type == "Gen-Int" else OSEG
    return dict(token_type=token_type, cam_encoder_type=cam,
                hseg_token_idx=HSEG, oseg_token_idx=oseg)


def _heads_only(tcfg, params):
    tm = InteractVLM(tcfg, device="cpu")
    sd = {}
    W._heads(params["params"], sd)
    missing, unexpected = tm.load_state_dict(sd, strict=False)
    assert not unexpected and sd
    return tm


@pytest.mark.parametrize("token_type,cam", COND_CASES,
                         ids=[f"{t}-{c}" for t, c in COND_CASES])
def test_condition_views_match_jax(token_type, cam):
    kw = _cfg_kw(token_type, cam)
    jcfg, tcfg = jax_tiny(**kw), interactvlm_tiny(**kw)
    rng = _rng(10)
    emb = _normal(rng, (4, 32))
    cams = rng.random((4, 4, 5)).astype(np.float32)
    tok = np.array([jcfg.seg_token_idx, HSEG, OSEG, 7], np.int32)
    jm = JaxIVLM(jcfg)
    args = (jnp.asarray(emb), jnp.asarray(cams), jnp.asarray(tok))
    params = _np(jm.init(jax.random.PRNGKey(11), *args,
                         method=JaxIVLM.condition_views))
    tm = _heads_only(tcfg, params)
    want = jm.apply(params, *args, method=JaxIVLM.condition_views)
    got = tm.condition_views(torch.from_numpy(emb), torch.from_numpy(cams),
                             torch.from_numpy(tok))
    _close(got, want, HEAD_TOL)
    if token_type != "Gen":
        # [SEG] and other rows keep the unsplit tokens; under Gen-Int the
        # shared id takes the human branch
        tm.config = dataclasses.replace(tcfg, token_type="Gen")
        plain = tm.condition_views(torch.from_numpy(emb),
                                   torch.from_numpy(cams))
        tm.config = tcfg
        assert torch.equal(got[0], plain[0]) and torch.equal(got[3], plain[3])
        assert not torch.allclose(got[1], plain[1])


def test_seg_embeddings_k_match_jax():
    kw = _cfg_kw("Gen-Hu-Obj", "simple")
    jcfg, tcfg = jax_tiny(**kw), interactvlm_tiny(**kw)
    L = 10
    ids = np.full((3, L), 7, np.int32)
    ids[0, 3], ids[0, 6] = HSEG, OSEG  # both, in order
    ids[1, 2] = jcfg.seg_token_idx  # one
    ids[2, 0] = HSEG  # no position predicts the first token
    hidden = _normal(_rng(12), (3, L, jcfg.llama.hidden_size))
    jm = JaxIVLM(jcfg)
    args = (jnp.asarray(hidden), jnp.asarray(ids))
    params = _np(jm.init(jax.random.PRNGKey(13), *args, 2,
                         method=JaxIVLM.seg_embeddings_k))
    tm = _heads_only(tcfg, params)
    we, wt, wv = jm.apply(params, *args, 2, method=JaxIVLM.seg_embeddings_k)
    ge, gt, gv = tm.seg_embeddings_k(torch.from_numpy(hidden),
                                     torch.from_numpy(ids).long(), 2)
    _close(ge, we, HEAD_TOL)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert gv.tolist() == [[True, True], [True, False], [False, False]]
    assert int(torch.count_nonzero(ge[2])) == 0
    assert gt[0].tolist() == [HSEG, OSEG]
    # slot 0 is the single-token path
    e1, t1, h1 = tm.seg_embeddings(torch.from_numpy(hidden),
                                   torch.from_numpy(ids).long())
    assert torch.equal(ge[:, 0], e1) and torch.equal(gt[:, 0], t1)
