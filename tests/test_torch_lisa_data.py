"""The port's LISA datasets against the JAX package's, on the CPU at 64^2:
``rle_decode`` and ``fill_polygon`` bit for bit, the five datasets item by
item from the same seeds (``plan(idx)()`` and ``ds[idx]``), every
``SemSegLISADataset`` corpus (ade20k and cocostuff remaps, the all-ignore
fall-through, mapillary's "P" PNGs, the paco and pascal_part phrasings),
refcoco / refcocog (``umd``) / refclef with G_REFER lists (an empty one
among them), ReasonSeg's explanatory mix, ``build_dataset`` for the five
names (``num_conversations = 3``, the ``--fixed_templates`` refusal), the
LISA mixture (``sem_seg_lisa||refer_seg_lisa||vqa||reason_seg`` at
9,3,3,1) collated with one and three conversations and taken through one
tiny ``TrainStep`` against the JAX step, and the data ranks of a 2 x 1
layout on that mixture.

The tree is ``utils/lisa_tree.write_lisa_tree`` at 1/16 of the corpora's
photo sizes.

Tolerances: strings, ids, masks and labels equal exactly; ``sam_images``
and ``image_clip`` within 1e-6 (both sides read the same JPEGs through
PIL and run the same numpy transforms); the training step's loss terms
and gradient norm within 1e-4 relative (f32 on both sides, summed in other
orders: ``tests/test_torch_drivers.py``'s step tolerance).
"""

import random

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from interactvlm_tpu.data import collate as JC
from interactvlm_tpu.data import datasets as JD
from interactvlm_tpu.train import train as JTR
from interactvlm_tpu.utils import constants as JK
from interactvlm_tpu.utils.testing import WhitespaceTokenizer as JaxTok
from interactvlm_tpu_torch.data import collate as TC
from interactvlm_tpu_torch.data import datasets as TD
from interactvlm_tpu_torch.parallel.launch import spawn
from interactvlm_tpu_torch.parallel.mesh import Mesh
from interactvlm_tpu_torch.train import train as TTR
from interactvlm_tpu_torch.train.optimizer import make_optimizer
from interactvlm_tpu_torch.train.train_step import TrainStep, take_rows
from interactvlm_tpu_torch.utils import constants as TK
from interactvlm_tpu_torch.utils.lisa_tree import (
    polygon,
    rle_encode,
    write_lisa_tree,
)
from interactvlm_tpu_torch.utils.testing import WhitespaceTokenizer as PortTok
from interactvlm_tpu_torch.utils.weights import from_jax_params

from tests import torch_ranks as R
from tests.test_torch_data import assert_batches_equal

S = 64
IMG_TOL = 1e-6
STEP_RTOL = 1e-4
LOSS_KEYS = ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
             "mask_l2_loss", "mask_loss", "hC_loss", "oA_loss", "oC_loss")
LISA_NAMES = ("refer_seg", "refer_seg_lisa", "reason_seg", "sem_seg",
              "sem_seg_lisa")
MIXTURE = ["--dataset", "sem_seg_lisa||refer_seg_lisa||vqa||reason_seg",
           "--sample_rates", "9,3,3,1"]
TINY = ["--tokenizer", "whitespace", "--model_scale", "tiny",
        "--image_size", str(S), "--clip_size", "28",
        "--model_max_length", "384"]


def make_lisa_tree(root):
    """The tests' LISA tree: every layout, photos at 1/16 of the
    corpora's sizes (ade20k 43 x 32)."""
    write_lisa_tree(str(root), n_ade=5, n_refcoco=4, n_reason=6, n_other=2,
                    n_vqa=3, scale=1 / 16)
    return str(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_lisa_tree(tmp_path_factory.mktemp("lisa"))


def assert_seg_samples_equal(a, b):
    for f in ("image_path", "conversations", "resize", "questions",
              "sampled_classes", "ds_name", "mask_paths", "inference"):
        assert getattr(a, f) == getattr(b, f), (f, getattr(a, f),
                                                getattr(b, f))
    for f in ("masks", "label", "gt_contact_3d", "cam_params"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in ("sam_images", "image_clip"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_allclose(x, y, atol=IMG_TOL, rtol=0, err_msg=f)


# ------------------------------------------------------- RLE and polygons
def _runs(mask):
    flat = mask.T.reshape(-1)
    counts, prev, run = [], 0, 0
    for v in flat:
        if v == prev:
            run += 1
        else:
            counts.append(run)
            prev, run = v, 1
    return counts + [run]


RLE_CASES = {
    # a wide run then short ones: deltas against two back go negative
    "compressed-negative-deltas": lambda m: rle_encode(m),
    "compressed-bytes": lambda m: dict(rle_encode(m),
                                       counts=rle_encode(m)["counts"]
                                       .encode()),
    "uncompressed-list": lambda m: {"size": list(m.shape),
                                    "counts": _runs(m)},
}


@pytest.mark.parametrize("case", sorted(RLE_CASES))
def test_rle_decode_equals_jax(case):
    rng = np.random.default_rng(3)
    masks = [(rng.random((9, 7)) > 0.5).astype(np.uint8),
             np.zeros((5, 6), np.uint8), np.ones((4, 3), np.uint8)]
    big = np.zeros((40, 50), np.uint8)
    big[2:38, 5:45] = 1
    big[10:12, 7:9] = 0
    masks.append(big)
    for m in masks:
        rle = RLE_CASES[case](m)
        got = TD.rle_decode(rle)
        want = JD.rle_decode(rle)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, m)
    enc = rle_encode(big)["counts"]
    assert any(ord(c) - 48 & 0x20 for c in enc)  # multi-group values


POLY_CASES = {
    "concave-star": lambda rng: polygon(rng, 40, 30, n=9),
    "pixel-centre-vertices": lambda rng: [2.5, 2.5, 10.5, 2.5, 10.5, 8.5,
                                          6.5, 5.5, 2.5, 8.5],
    "off-image": lambda rng: polygon(rng, 40, 30, off_image=True) + [
        45.0, 35.0],
    "degenerate": lambda rng: [1.0, 1.0, 3.0, 3.0],
    "horizontal-edges": lambda rng: [0.0, 0.5, 20.0, 0.5, 20.0, 10.5,
                                     0.0, 10.5],
}


@pytest.mark.parametrize("case", sorted(POLY_CASES))
def test_fill_polygon_equals_jax(case):
    rng = np.random.default_rng(5)
    for _ in range(4):
        pts = POLY_CASES[case](rng)
        got, want = TD.fill_polygon(pts, 30, 40), JD.fill_polygon(pts, 30, 40)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- datasets
CASES = {
    "sem_seg_lisa-ade20k": ("SemSegLISADataset", dict(dataset="ade20k")),
    "sem_seg_lisa-ade20k-3": ("SemSegLISADataset",
                              dict(dataset="ade20k",
                                   num_classes_per_sample=3)),
    "sem_seg_lisa-cocostuff": ("SemSegLISADataset",
                               dict(dataset="cocostuff")),
    "sem_seg_lisa-mapillary": ("SemSegLISADataset",
                               dict(dataset="mapillary")),
    "sem_seg_lisa-paco_lvis": ("SemSegLISADataset",
                               dict(dataset="paco_lvis")),
    "sem_seg_lisa-paco_lvis-3": ("SemSegLISADataset",
                                 dict(dataset="paco_lvis",
                                      num_classes_per_sample=3)),
    "sem_seg_lisa-pascal_part": ("SemSegLISADataset",
                                 dict(dataset="pascal_part")),
    "refer_seg_lisa-refcoco": ("ReferSegLISADataset",
                               dict(dataset="refcoco")),
    "refer_seg_lisa-refcoco-val-3": ("ReferSegLISADataset",
                                     dict(dataset="refcoco", split="val",
                                          num_classes_per_sample=3)),
    "refer_seg_lisa-refcocog": ("ReferSegLISADataset",
                                dict(dataset="refcocog")),
    "refer_seg_lisa-refclef": ("ReferSegLISADataset",
                               dict(dataset="refclef")),
    "reason_seg-train": ("ReasonSegDataset", dict()),
    "reason_seg-val-explanatory": ("ReasonSegDataset",
                                   dict(split="val", explanatory=0.6)),
    "sem_seg": ("SemSegDataset", dict()),
    "sem_seg-2": ("SemSegDataset", dict(num_classes_per_sample=2)),
    "refer_seg": ("ReferSegDataset", dict()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dataset_items_equal(tree, case):
    cls, kw = CASES[case]
    kw = dict(kw, image_size=S, clip_size=28)
    for seed in (0, 1):
        jd = getattr(JD, cls)(tree, rng=random.Random(seed), **kw)
        td = getattr(TD, cls)(tree, rng=random.Random(seed), **kw)
        assert len(td) == len(jd) > 0
        for idx in list(range(len(td))) * 2:
            assert_seg_samples_equal(td.plan(idx)(), jd[idx])
            assert_seg_samples_equal(td[idx], jd[idx])


def test_the_corpora_cover_what_the_datasets_branch_on(tree):
    """The tree reaches every branch the item tests hold: fall-through
    from all-ignore maps, remapped ids, both paco phrasings, an empty
    G_REFER list (a zero mask), refcocog's umd split and ReasonSeg's three
    explanatory choices."""
    kw = dict(image_size=S, clip_size=28)
    ade = TD.SemSegLISADataset(tree, dataset="ade20k", **kw)
    last = ade[len(ade) - 1]  # its map is all unlabeled: item 0 instead
    assert last.image_path == ade.images[0]
    coco = TD.SemSegLISADataset(tree, dataset="cocostuff", **kw)
    assert coco[0].image_path == coco.images[1]  # only "-" classes in 0
    names = {n for i in range(40) for n in TD.SemSegLISADataset(
        tree, dataset="paco_lvis", rng=random.Random(i), **kw)[0]
        .sampled_classes}
    assert "table" in names  # an object category, not a part
    assert any(n.startswith("the ") and " of the " in n for n in names)
    assert any(n in ("chair leg", "mug handle", "bottle cap") for n in names)
    ref = TD.ReferSegLISADataset(tree, dataset="refcoco", **kw)
    empty = [r for refs in ref.img2refs.values() for r in refs
             if r["ann_id"] == []]
    assert empty and not ref._ref_mask(empty[0], 8, 8).any()
    assert len(TD.ReferSegLISADataset(tree, dataset="refcocog", **kw)) > 0
    reason = TD.ReasonSegDataset(tree, explanatory=0.5, **kw)
    answers = set()
    for seed in range(24):
        reason.rng = random.Random(seed)
        conv = reason[0].conversations[0]
        answers.add(("[SEG]" in conv, "explanation" in conv.lower()
                     or "seating" in conv))
    assert len(answers) >= 2


# --------------------------------------------------------- build_dataset
def _args(**kw):
    args = JTR.parse_args(TINY + MIXTURE + ["--dataset_dir", "x"])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


@pytest.mark.parametrize("name", LISA_NAMES)
def test_build_dataset_lisa_names(tree, name):
    for conv in (1, 3):
        args = _args(num_conversations=conv)
        jd = JD.build_dataset(name, tree, "train", args)
        td = TD.build_dataset(name, tree, "train", args)
        assert type(td).__name__ == type(jd).__name__
        assert td.num_classes_per_sample == jd.num_classes_per_sample
        for i in range(len(td)):
            assert_seg_samples_equal(td[i], jd[i])
    for mod in (JD, TD):
        with pytest.raises(ValueError, match="fixed_templates"):
            mod.build_dataset(name, tree, "train",
                              _args(fixed_templates=True))
    assert name not in TD.FIXED_TEMPLATE_SAFE
    assert set(TD.DATASET_REGISTRY) == set(JD.DATASET_REGISTRY)


# ------------------------------------------------------------ the mixture
def tokenizers():
    jt, pt = JaxTok(384), PortTok(384)
    jt, *jids = JK.add_new_tokens(jt, "Gen")
    pt, *pids = TK.add_new_tokens(pt, "Gen")
    assert jids == pids
    return jt, pt, dict(zip(("seg_token_idx", "hseg_token_idx",
                             "oseg_token_idx"), pids))


@pytest.mark.parametrize("conv", [1, 3])
def test_lisa_mixture_picks_and_collate_equal(tree, conv):
    args = _args(num_conversations=conv)
    names = args.dataset.split("||")
    jds = [JD.build_dataset(n, tree, "train", args) for n in names]
    tds = [TD.build_dataset(n, tree, "train", args) for n in names]
    jh = JD.HybridDataset(jds, [9, 3, 3, 1], samples_per_epoch=16)
    th = TD.HybridDataset(tds, [9, 3, 3, 1], samples_per_epoch=16)
    jt, pt, _ = tokenizers()
    kinds = set()
    for _ in range(3):
        js = [jh[0] for _ in range(6)]
        ts = [th[0] for _ in range(6)]
        for a, b in zip(ts, js):
            assert_seg_samples_equal(a, b)
            kinds.add(a.ds_name)
        want, wmeta = JC.collate(js, jt, max_len=384, num_conversations=conv)
        got, gmeta = TC.collate(ts, pt, max_len=384, num_conversations=conv)
        assert_batches_equal(got, {k: np.asarray(v) for k, v in
                                   want.items()})
        assert gmeta["ds_name_list"] == wmeta["ds_name_list"]
    assert {"sem_seg", "refer_seg"} <= kinds


def _np(tree):
    return jax.tree.map(np.array, nn.meta.unbox(tree))


def test_train_step_on_a_lisa_batch_matches_jax(tree):
    """One JAX step (the file's one compile) against ``TrainStep`` on the
    same LISA mixture batch, three conversations a row, seg rows of every
    kind, from the same weights."""
    from interactvlm_tpu.parallel.mesh import create_mesh
    from interactvlm_tpu.train.optimizer import make_optimizer as jax_opt
    from interactvlm_tpu.train.optimizer import trainable_mask
    from interactvlm_tpu.train.train_step import (
        create_sharded_state,
        make_train_step,
    )

    args = _args(num_conversations=3)
    names = args.dataset.split("||")
    jt, pt, token_kw = tokenizers()
    picks = [("sem_seg_lisa", 0), ("refer_seg_lisa", 1), ("vqa", 0),
             ("reason_seg", 2)]
    jds = {n: JD.build_dataset(n, tree, "train", args) for n in names}
    tds = {n: TD.build_dataset(n, tree, "train", args) for n in names}
    js = [jds[n][i] for n, i in picks]
    ts = [tds[n][i] for n, i in picks]
    jbatch, _ = JC.collate(js, jt, max_len=384, num_conversations=3)
    tbatch, _ = TC.collate(ts, pt, max_len=384, num_conversations=3)
    assert set(np.asarray(jbatch["task_ids"]).tolist()) >= {0, 1}
    jm, _ = JTR.build_model_and_config(args, **token_kw)
    mesh = create_mesh(n_data=1, n_model=1, devices=jax.devices()[:1])
    tx, _ = jax_opt(lr=1e-3, warmup_steps=0, total_steps=10,
                    mask=trainable_mask)
    with mesh:
        state, shardings = create_sharded_state(jm, tx, jbatch, mesh)
        params = _np(state.params)
        rng = np.random.default_rng(0)
        for name, layer in params["params"]["llava"]["lm"]["model"].items():
            if name.startswith("layer_"):
                for proj in ("q_proj", "v_proj"):
                    b = layer["self_attn"][proj]["lora_b"]
                    b[...] = rng.standard_normal(b.shape) * 0.05
        state = state.replace(params=jax.tree.map(jnp.asarray, params),
                              opt_state=tx.init(params))
        step = make_train_step(jm, tx, mesh, shardings, jbatch, donate=False)
        _, jmetrics = step(state, jbatch)
        jmetrics = jax.tree.map(float, jmetrics)
    tm, _ = TTR.build_model_and_config(args, device="cpu", **token_kw)
    missing, unexpected = tm.load_state_dict(from_jax_params(params),
                                             strict=False)
    assert not unexpected and all("mask_downscaling" in k for k in missing)
    opt, sched = make_optimizer(tm, lr=1e-3, warmup_steps=0, total_steps=10)
    m = TrainStep(tm, opt, sched)(tbatch)
    assert jmetrics["mask_loss"] > 0 and jmetrics["ce_loss"] > 0
    for k in LOSS_KEYS + ("grad_norm",):
        np.testing.assert_allclose(m[k].item(), jmetrics[k], rtol=STEP_RTOL,
                                   atol=1e-7, err_msg=k)


def test_train_cli_real_batches_on_the_lisa_mixture_equal_jax(tree):
    """``real_batch_iter``'s first two batches of the mixture (three
    conversations a row) on both sides, one loader thread each (the JAX
    loader makes its draws in its threads)."""
    from argparse import Namespace

    argv = TINY + MIXTURE + ["--dataset_dir", tree, "--batch_size", "4",
                             "--data_workers", "1", "--prefetch_depth", "1",
                             "--steps_per_epoch", "2",
                             "--num_conversations", "3"]
    cfg = Namespace(num_human_vertices=6890, num_object_points=2048,
                    max_seg_tokens=1)
    jt, pt, _ = tokenizers()
    jit = JTR.real_batch_iter(JTR.parse_args(argv), cfg, jt)
    pit = TTR.real_batch_iter(TTR.parse_args(argv), cfg, pt)
    for _ in range(2):
        want = next(jit)
        assert_batches_equal(next(pit), {k: np.asarray(v)
                                         for k, v in want.items()})
    pit.close()


@pytest.mark.parametrize("workers", [1, 3])
def test_data_ranks_collate_the_one_process_rows(tree, workers):
    """The real loader on two data ranks over the LISA mixture: each
    rank's batches are its half of the one-process loader's rows, every
    draw (mixture, classes, sentences, templates, explanations) included,
    whatever the number of workers on the ranks."""
    def argv(w):
        return TINY + MIXTURE + [
            "--dataset_dir", tree, "--batch_size", "4",
            "--data_workers", str(w), "--prefetch_depth", "1"]

    one = R.loader(Mesh(), argv(1), 2)
    ranks = spawn(R.loader, 2, args=(argv(workers), 2))
    for r, got in enumerate(ranks):
        for b, want in zip(got, one):
            want = take_rows(want, [2 * r, 2 * r + 1], 4)
            assert set(b) == set(want)
            for k in want:
                np.testing.assert_array_equal(b[k], want[k], err_msg=k)
