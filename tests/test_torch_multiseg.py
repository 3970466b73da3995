"""The port's interaction branches end to end against the JAX package, on
``interactvlm_tiny`` with the same weights (carried by ``from_jax_params``)
and the same numpy batches: ``forward_train`` with per-row DifDe routing
(``Gen-DifDe``) and with the splitter and ``vi_v1`` cams (``Gen-Hu-Obj``,
ocontact rows), ``_forward_train_multiseg`` at K = 2 (``Gen-Hu-Obj-DifDe``
with fusion; ``Gen-Int`` with ``view_index`` cams), with every trainable's
gradient; ``evaluate_batch`` for oafford, ocontact (per-sample maps, and
``meta``'s original-frame masks), the demo's object maps and a DifDe
hcontact on a cached embedding; ``_evaluate_batch_multiseg`` on one
fabricated generation (a row with [HSEG] and [OSEG], rows with one, a row
with none), streaming and cached; and one whole K = 2 ``evaluate_batch``
whose answers carry both tokens.

One JAX init serves every configuration: the ``Gen-Hu-Obj-DifDe`` + fusion
tree holds every module the others have, except the ``simple`` and
``view_index`` cam encoders, which are initialised alone; each other
configuration takes the subset its model has.

Tolerances (f32 on the CPU on both sides, differing in summation order
through LLaMA, SAM's decoders, the upsampling and the lifts' scatters):
generated ids identical; mask logits within 1e-4 absolute and relative;
contacts and lifts within 1e-5; losses within 1e-5 relative (plus 1e-6
absolute); gradients at ``tests/test_torch_train.py``'s tolerance: each
trainable's within 1e-3 of its own largest magnitude (plus 1e-3 relative
and 1e-7 of the model's largest gradient, where exact zeros come out as
rounding noise) and its norm within 1e-4 relative.
"""

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as nn
import pytest
import torch

from interactvlm_tpu.config import interactvlm_tiny as jax_tiny
from interactvlm_tpu.eval import evaluate as JE
from interactvlm_tpu.models.interactvlm import InteractVLM as JaxIVLM
from interactvlm_tpu.utils.testing import make_synthetic_batch as jax_batch
from interactvlm_tpu_torch.config import interactvlm_tiny
from interactvlm_tpu_torch.eval import evaluate as TE
from interactvlm_tpu_torch.models.interactvlm import InteractVLM
from interactvlm_tpu_torch.train.optimizer import trainable_mask
from interactvlm_tpu_torch.utils.weights import from_jax_params

MASK, T, HSEG, OSEG = 32, 4, 501, 502
MASK_TOL, LIFT_TOL, LOSS_RTOL, NOISE = 1e-4, 1e-5, 1e-5, 1e-7
LOSS_KEYS = ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
             "mask_l2_loss", "mask_loss", "hC_loss", "oA_loss", "oC_loss")
FULL = dict(token_type="Gen-Hu-Obj-DifDe", cam_encoder_type="vi_v1",
            hseg_token_idx=HSEG, oseg_token_idx=OSEG, use_fusion=True)
CONFIGS = {
    "hu-obj-difde-fusion-k2": dict(FULL, max_seg_tokens=2),
    "gen-int-view_index-k2": dict(token_type="Gen-Int",
                                  cam_encoder_type="view_index",
                                  hseg_token_idx=HSEG, oseg_token_idx=HSEG,
                                  max_seg_tokens=2),
    "gen-difde": dict(token_type="Gen-DifDe"),
    "hu-obj-vi_v1": dict(token_type="Gen-Hu-Obj", cam_encoder_type="vi_v1",
                         hseg_token_idx=HSEG, oseg_token_idx=OSEG),
    "hu-obj-difde": dict(FULL, use_fusion=False),
}


def _np(tree):
    return jax.tree.map(np.array, nn.meta.unbox(tree))


def _copy(tree):
    return jax.tree.map(np.array, tree)


@pytest.fixture(scope="module")
def full():
    jcfg = jax_tiny(**CONFIGS["hu-obj-difde-fusion-k2"])
    batch = jax_batch(jcfg, B=2, L=12, tasks=(2, 3), mask_size=MASK)
    return _np(jax.jit(JaxIVLM(jcfg).init)(jax.random.PRNGKey(0), batch))


def _tree(full, kw):
    """The full tree cut to the modules a configuration's model has: its
    own cam encoder initialised alone if the full tree's is another kind."""
    jcfg = jax_tiny(**kw)
    jm = JaxIVLM(jcfg)
    tree = _copy(full)
    p = tree["params"]
    if "DifDe" not in jcfg.token_type:
        for name in ("human_mask_decoder", "object_mask_decoder"):
            p["sam"].pop(name)
    if not jcfg.use_fusion:
        p.pop("fusion")
    if jcfg.base_token_type not in ("Gen-Hu-Obj", "Gen-Int"):
        p.pop("attention_splitter")
    if jcfg.cam_encoder_type != "vi_v1":
        rng = np.random.default_rng(1)
        args = (jnp.asarray(rng.standard_normal((2, jcfg.out_dim)),
                            jnp.float32),
                jnp.asarray(rng.random((2, 4, 5)), jnp.float32),
                jnp.zeros((2,), jnp.int32))
        heads = _np(jm.init(jax.random.PRNGKey(2), *args,
                            method=JaxIVLM.condition_views))
        p["cam_pose_encoder"] = heads["params"]["cam_pose_encoder"]
    return jcfg, jm, tree


def _port(tree, kw):
    tm = InteractVLM(interactvlm_tiny(**kw), device="cpu")
    missing, unexpected = tm.load_state_dict(from_jax_params(tree),
                                             strict=False)
    assert not unexpected, unexpected
    assert all("mask_downscaling" in k for k in missing), missing
    return tm


def _ocontact_fields(batch, cfg, seed=3):
    """The collate's object-contact payload: per-sample corner-major maps
    (3, B, V, H, W), targets and valid vertices."""
    rng = np.random.default_rng(seed)
    B, V, P = batch["input_ids"].shape[0], cfg.multiview_channels, \
        cfg.num_object_points
    p2v = rng.integers(-1, P, (B, V, MASK, MASK, 3)).astype(np.int32)
    bary = rng.dirichlet([1, 1, 1], (B, V, MASK, MASK)).astype(np.float32)
    return {"gt_ocontact": (rng.random((B, P)) > 0.7).astype(np.float32),
            "obj_p2v": np.ascontiguousarray(np.moveaxis(p2v, -1, 0)),
            "obj_bary": np.ascontiguousarray(np.moveaxis(bary, -1, 0)),
            "obj_valid_verts": np.ones((B, P), np.float32)}


def _train_batch(name, jcfg):
    """(JAX batch, numpy batch) for a training case."""
    # hcontact, oafford, ocontact and 2D-seg rows (the last takes DifDe's
    # default decoder)
    tasks = {"gen-difde": (2, 3, 1), "hu-obj-vi_v1": (2, 4)}.get(
        name, (2, 3, 4))
    B = len(tasks)
    jb = dict(jax_batch(jcfg, B=B, L=12, tasks=tasks, mask_size=MASK))
    nb = {k: np.array(v) for k, v in jb.items()}
    if name == "hu-obj-vi_v1":  # row 0 says [HSEG], row 1 [OSEG]
        for row, tok in ((0, HSEG), (1, OSEG)):
            nb["input_ids"][row, -2] = tok
            nb["labels"][row, -2] = tok
    if 4 in tasks:
        nb.update(_ocontact_fields(nb, jcfg))
    if name == "gen-int-view_index-k2":  # a row with one seg token
        nb["input_ids"][1, -4] = 7
    return {k: jnp.asarray(v) for k, v in nb.items()}, nb


TRAIN_CASES = ["hu-obj-difde-fusion-k2", "gen-int-view_index-k2",
               "gen-difde", "hu-obj-vi_v1"]


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_forward_train_and_gradients_match_jax(full, name):
    kw = CONFIGS[name]
    jcfg, jm, tree = _tree(full, kw)
    jb, nb = _train_batch(name, jcfg)

    def loss_fn(p):
        out = jm.apply(p, jb)
        return out["loss"], out

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        tree)
    tm = _port(tree, kw)
    mask = trainable_mask(n for n, _ in tm.named_parameters())
    for n, p in tm.named_parameters():
        p.requires_grad_(mask[n])
    got = tm({k: torch.from_numpy(v) for k, v in nb.items()})
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["pred_masks"].detach().numpy(),
                               np.asarray(want["pred_masks"]), rtol=MASK_TOL,
                               atol=MASK_TOL)
    if jcfg.max_seg_tokens > 1:
        assert got["pred_masks"].shape[:2] == (len(nb["task_ids"]), 2)
    assert got["hC_loss"].item() > 0 and got["mask_loss"].item() > 0
    if name == "hu-obj-vi_v1":
        assert got["oC_loss"].item() > 0

    got["loss"].backward()
    want_g = from_jax_params(_np(grads))
    floor = NOISE * max(np.abs(w.numpy()).max() for w in want_g.values())
    held = set()
    for n, p in tm.named_parameters():
        if not mask[n]:
            continue
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        w = want_g[n].numpy()
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3 * scale + floor,
                                   err_msg=n)
        if scale > floor:
            np.testing.assert_allclose(np.linalg.norm(g), np.linalg.norm(w),
                                       rtol=1e-4, err_msg=n)
            held.add(n.split(".")[0] if not n.startswith("sam.")
                     else n.split(".")[1])
    # the new heads and the routed decoders all trained
    expect = {"text_hidden_fcs", "cam_pose_encoder", "mask_decoder"}
    if "DifDe" in jcfg.token_type:
        expect |= {"human_mask_decoder", "object_mask_decoder"}
    if jcfg.base_token_type in ("Gen-Hu-Obj", "Gen-Int"):
        expect.add("attention_splitter")
    if jcfg.use_fusion:
        expect.add("fusion")
    assert expect <= held, expect - held


# ------------------------------------------------------------------ evaluate
def _force(tree, first, then=None):
    """Make every answer start with token ``first``: a large constant
    channel 0 in the residual stream (the embeddings and the projected
    patches) and ``first``'s lm_head weight on it. With ``then``, the
    embedding of ``first`` also carries a channel 1 that points the
    lm_head at ``then``, so answers alternate first, then, first, ..."""
    tree = _copy(tree)
    p = tree["params"]["llava"]
    emb = p["lm"]["model"]["embed_tokens"]["embedding"]
    emb[:, 0] = 30.0
    p["mm_projector"]["bias"][0] = 30.0
    head = p["lm"]["lm_head"]["kernel"]
    head[0, first] = 5.0
    if then is not None:
        emb[first, 1] = 90.0
        head[1, then] = 5.0
    return tree


@pytest.fixture(scope="module")
def evalset(full):
    kw = CONFIGS["hu-obj-difde"]
    jcfg, jm, tree = _tree(full, kw)
    jb = dict(jax_batch(jcfg, B=3, L=12, tasks=(2, 3, 4), mask_size=MASK))
    nb = {k: np.array(v) for k, v in jb.items()}
    nb.update(_ocontact_fields(nb, jcfg, seed=4))
    rng = np.random.default_rng(5)
    V, P = jcfg.multiview_channels, jcfg.num_object_points
    obj = rng.integers(-1, P, (V, MASK, MASK, 3)).astype(np.int32)
    maps = {
        "human": {"p2v": nb["human_p2v"], "bary": nb["human_bary"],
                  "num_vertices": jcfg.num_human_vertices},
        "object": {"p2v": np.ascontiguousarray(np.moveaxis(obj, -1, 0)),
                   "bary": np.ascontiguousarray(np.moveaxis(
                       rng.dirichlet([1, 1, 1], (V, MASK, MASK)).astype(
                           np.float32), -1, 0)),
                   "num_vertices": P}}
    return jcfg, jm, tree, nb, maps


def _jemb(jm, tree, nb):
    return jm.apply(tree, jnp.asarray(nb["sam_images"][:1]),
                    method=JaxIVLM.encode_sam_images)


def _temb(tm, nb):
    with torch.inference_mode():
        return tm.encode_sam_images(torch.from_numpy(nb["sam_images"][:1]))


EVAL_CASES = {
    # contact type, forced token, batch keys dropped, object maps, meta,
    # cached embedding
    "oafford": ("oafford", OSEG, (), False, False, False),
    "ocontact-meta": ("ocontact", OSEG, (), False, True, False),
    "object_maps": ("ocontact", HSEG, ("obj_p2v", "obj_bary"), True, False,
                    False),
    "hcontact-cached": ("hcontact", HSEG, (), False, False, True),
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_evaluate_batch_branches_match_jax(evalset, case):
    contact, tok, drop, use_obj, use_meta, cached = EVAL_CASES[case]
    jcfg, jm, tree, nb, maps = evalset
    tree = _force(tree, tok)
    tm = _port(tree, CONFIGS["hu-obj-difde"])
    nb = {k: v for k, v in nb.items() if k not in drop}
    meta = None
    if use_meta:
        meta = {"resize_list": [(48, 40), (64, 64), (40, 64)],
                "label_list": [np.zeros((96, 80)), np.zeros((30, 25)),
                               np.zeros((60, 96))]}
    kw = dict(max_new_tokens=T, human_maps=maps["human"],
              object_maps=maps["object"] if use_obj else None, meta=meta)
    want = JE.evaluate_batch(
        jm, tree, {k: jnp.asarray(v) for k, v in nb.items()}, jcfg, MASK,
        contact, cached_image_emb=_jemb(jm, tree, nb) if cached else None,
        **kw)
    got = TE.evaluate_batch(tm, nb, MASK, contact,
                            cached_image_emb=_temb(tm, nb) if cached else None,
                            **kw)
    np.testing.assert_array_equal(got["generated_ids"].numpy(),
                                  want["generated_ids"])
    assert bool(got["has_seg"].all())
    assert (got["generated_ids"][:, 0] == tok).all()
    np.testing.assert_allclose(got["pred_masks"].numpy(), want["pred_masks"],
                               atol=MASK_TOL, rtol=MASK_TOL)
    np.testing.assert_allclose(got["pred_contact_3d"].numpy(),
                               want["pred_contact_3d"], atol=LIFT_TOL)
    assert float(got["pred_contact_3d"].max()) > 0
    if use_meta:
        assert len(got["pred_masks_original"]) == 3
        for g, w, lab in zip(got["pred_masks_original"],
                             want["pred_masks_original"], meta["label_list"]):
            assert tuple(g.shape) == lab.shape
            np.testing.assert_allclose(g.numpy(), w, atol=MASK_TOL,
                                       rtol=MASK_TOL)
    else:
        assert got["pred_masks_original"] is None


def _fabricated_generation(jcfg, B=4, Tg=6, seed=6):
    """Generated ids with [HSEG] and [OSEG] in row 0, [OSEG] alone in row 1,
    no seg token in row 2 and [SEG] alone in row 3; random step hiddens."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 400, (B, Tg)).astype(np.int32)
    ids[0, 1], ids[0, 4] = HSEG, OSEG
    ids[1, 3] = OSEG
    ids[3, 2] = jcfg.seg_token_idx
    hidden = rng.standard_normal((B, Tg, jcfg.llama.hidden_size)).astype(
        np.float32)
    return ids, hidden


@pytest.mark.parametrize("cached,contact", [(False, "hcontact"),
                                            (True, "ocontact")])
def test_evaluate_batch_multiseg_matches_jax(evalset, cached, contact):
    jcfg, jm, tree, nb, maps = evalset
    kw2 = dict(CONFIGS["hu-obj-difde"], max_seg_tokens=2)
    jcfg = jax_tiny(**kw2)
    tm = _port(tree, kw2)
    ids, hidden = _fabricated_generation(jcfg)
    B = ids.shape[0]
    nb = {k: (np.concatenate([v, v[:1]]) if k in ("cam_params", "sam_images",
                                                  "gt_ocontact")
              else v) for k, v in nb.items()}
    for k in ("obj_p2v", "obj_bary"):
        nb[k] = np.concatenate([nb[k], nb[k][:, :1]], axis=1)
    is_seg = np.isin(ids, [jcfg.seg_token_idx, HSEG, OSEG])
    want = JE._evaluate_batch_multiseg(
        jm, tree, {k: jnp.asarray(v) for k, v in nb.items()}, jcfg, MASK,
        ids, is_seg, hidden, is_seg.any(1), 2, maps["human"], None,
        _jemb(jm, tree, nb) if cached else None, contact)
    got = TE._evaluate_batch_multiseg(
        tm, nb, MASK, torch.from_numpy(ids), torch.from_numpy(is_seg),
        torch.from_numpy(hidden), 2, maps["human"], None,
        _temb(tm, nb) if cached else None, contact)
    assert got["valid_k"].tolist() == [[True, True], [True, False],
                                       [False, False], [True, False]]
    np.testing.assert_array_equal(got["token_ids_k"].numpy(),
                                  want["token_ids_k"])
    np.testing.assert_array_equal(got["valid_k"].numpy(), want["valid_k"])
    for k in ("pred_masks_k", "pred_masks"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=MASK_TOL,
                                   rtol=MASK_TOL, err_msg=k)
    for k in ("pred_hcontact_3d", "pred_ocontact_3d", "pred_contact_3d"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=LIFT_TOL,
                                   err_msg=k)
    h3d, o3d = got["pred_hcontact_3d"], got["pred_ocontact_3d"]
    # rows without a slot of a kind lift nothing of it
    assert h3d[[1, 2]].abs().max() == 0 and h3d[[0, 3]].max() > 0
    assert o3d[[2, 3]].abs().max() == 0 and o3d[[0, 1]].max() > 0
    assert got["pred_masks_k"][2].abs().max() == 0


def test_whole_k2_evaluate_batch_matches_jax(evalset):
    """Answers forced to alternate [HSEG], [OSEG]: each row decodes two
    slots, one through each domain decoder, and lifts both."""
    jcfg, jm, tree, nb, maps = evalset
    kw2 = dict(CONFIGS["hu-obj-difde"], max_seg_tokens=2)
    tree = _force(tree, HSEG, then=OSEG)
    tm = _port(tree, kw2)
    kw = dict(max_new_tokens=T, human_maps=maps["human"], max_seg_tokens=2)
    want = JE.evaluate_batch(jm, tree, {k: jnp.asarray(v)
                                        for k, v in nb.items()},
                             jax_tiny(**kw2), MASK, "hcontact", **kw)
    got = TE.evaluate_batch(tm, nb, MASK, "hcontact", **kw)
    np.testing.assert_array_equal(got["generated_ids"].numpy(),
                                  want["generated_ids"])
    assert got["token_ids_k"].tolist() == [[HSEG, OSEG]] * 3
    np.testing.assert_allclose(got["pred_masks_k"].numpy(),
                               want["pred_masks_k"], atol=MASK_TOL,
                               rtol=MASK_TOL)
    for k in ("pred_hcontact_3d", "pred_ocontact_3d"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=LIFT_TOL,
                                   err_msg=k)
        assert float(got[k].max()) > 0
    assert not torch.allclose(got["pred_masks_k"][:, 0],
                              got["pred_masks_k"][:, 1])
