"""The port's object, 2D and VQA datasets and the flagship mixture
(``hcontact||ocontact||oafford||vqa`` at 9,9,5,2, ``Gen-Hu-Obj`` tokens,
``vi_v1`` cams: ``scripts/run_train.sh`` hcontact-ocontact) against the JAX
package's, on the CPU at 64^2: samples on the JAX package's trees and on
the port's, ``build_dataset`` with the preset's arguments, the 4-way
``HybridDataset``, ``collate`` of a batch holding all four kinds at K = 2,
``real_batch_iter``'s first two batches, one ``TrainStep`` on the first
batch against JAX's from the same weights, and the tiny flagship through
the train CLI and the eval CLI.

The trees come from ``tests/test_torch_datagen.py``'s inputs: DAMON under
``4MV-Z_Vitru``, PICO and PIAD under ``4MV-Z_HM_BM`` (a PIAD object that
affords nothing, and ranked object matches with a missing one), a flat
``vqa.pkl`` and a hand-made ``hcontact_2d`` tree.

Tolerances: samples, batches and picks equal element for element (the
data layer is exact); the training step's loss, each part and the
gradient norm within 1e-4 relative (``tests/test_torch_drivers.py``'s step
tolerance: f32 on both sides, summed in other orders).
"""

import os
import pickle
from argparse import Namespace
from os.path import join

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from interactvlm_tpu.data import collate as JC
from interactvlm_tpu.data import datasets as JD
from interactvlm_tpu.train import train as JTR
from interactvlm_tpu.utils import constants as JK
from interactvlm_tpu.utils.testing import WhitespaceTokenizer as JaxTok
from interactvlm_tpu_torch.data import collate as TC
from interactvlm_tpu_torch.data import datasets as TD
from interactvlm_tpu_torch.eval import evaluate as TE
from interactvlm_tpu_torch.train import train as TTR
from interactvlm_tpu_torch.train.checkpoints import CheckpointManager
from interactvlm_tpu_torch.train.optimizer import make_optimizer
from interactvlm_tpu_torch.train.train_step import TrainStep
from interactvlm_tpu_torch.utils import constants as TK
from interactvlm_tpu_torch.utils.testing import WhitespaceTokenizer as PortTok
from interactvlm_tpu_torch.utils.weights import from_jax_params

from tests.test_torch_data import assert_batches_equal, assert_samples_equal
from tests.test_torch_datagen import (
    HUMAN,
    OBJECT,
    S,
    run_recipe,
    write_input_files,
)

STEP_RTOL = 1e-4
N_POINTS = 300  # the PIAD clouds' points
LOSS_KEYS = ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
             "mask_l2_loss", "mask_loss", "hC_loss", "oA_loss", "oC_loss")
PHOTOS = ("img0.jpg", "img1.jpg", "img2.jpg", "img3.jpg", "chair_001.jpg",
          "ball_001.jpg", "mug_002.jpg", "mug_img.jpg", "cup_img.jpg",
          "vqa0.jpg", "vqa1.jpg", "h2d0.jpg", "h2d1.jpg")
# the preset's flags (scripts/run_train.sh hcontact-ocontact) at tiny size
FLAGSHIP = ["--dataset", "hcontact||ocontact||oafford||vqa",
            "--sample_rates", "9,9,5,2",
            "--token_type", "Gen-Hu-Obj", "--cam_encoder_type", "vi_v1",
            "--oC_sam_view_type", OBJECT, "--hC_sam_view_type", HUMAN,
            "--hC_question_type", "parts", "--oC_question_type", "afford",
            "--hC_loss_weight", "3.0", "--oC_loss_weight", "3.0"]
TINY = ["--tokenizer", "whitespace", "--model_scale", "tiny",
        "--image_size", str(S), "--clip_size", "28",
        "--num_human_vertices", "178", "--num_object_points", str(N_POINTS),
        "--model_max_length", "384"]


def write_flagship_tree(root, inputs, port: bool):
    """The four trees of the flagship mixture under ``root``, written by
    the port's recipes or the JAX package's, plus the photos, a flat
    ``vqa.pkl`` and an ``hcontact_2d`` tree."""
    rng = np.random.default_rng(5)
    os.makedirs(join(root, "images"), exist_ok=True)
    for name in PHOTOS:
        Image.fromarray(rng.integers(0, 255, (30, 38, 3), np.uint8)).save(
            join(root, "images", name))
    for recipe in ("damon", "pico", "piad"):
        run_recipe(recipe, root, inputs, port)
    with open(join(root, "vqa.pkl"), "wb") as f:
        pickle.dump([{"image": "vqa0.jpg",
                      "question": "What is the person doing ?",
                      "answer": "sitting on a chair ."},
                     {"image": "vqa1.jpg",
                      "question": "What object is being held ?",
                      "answer": "a ball ."}], f)
    h2d = join(root, "hcontact_2d")
    os.makedirs(join(h2d, "masks"))
    recs = []
    for i in range(2):
        m = np.zeros((30, 38), np.uint8)
        m[5 + 4 * i:20, 8:30 - 6 * i] = 255
        Image.fromarray(m).save(join(h2d, "masks", f"h2d{i}.png"))
        recs.append({"image": f"h2d{i}.jpg", "mask": f"h2d{i}.png",
                     "class_name": ["Chair", "bench"][i]})
    with open(join(h2d, "index.pkl"), "wb") as f:
        pickle.dump({"train": recs, "test": recs[::-1]}, f)
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    inputs = write_input_files(str(tmp_path_factory.mktemp("inputs")))
    return {side: write_flagship_tree(
        str(tmp_path_factory.mktemp(side)), inputs, side == "port")
        for side in ("jax", "port")}


def assert_object_samples_equal(a, b):
    assert_samples_equal(a, b)
    for f in ("obj_p2p", "obj_p2v", "obj_bary", "masks_k"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def flagship_args(tree, *extra):
    return JTR.parse_args(TINY + FLAGSHIP + ["--dataset_dir", tree]
                          + list(extra))


def tokenizers():
    jt, pt = JaxTok(384), PortTok(384)
    jt, *jids = JK.add_new_tokens(jt, "Gen-Hu-Obj")
    pt, *pids = TK.add_new_tokens(pt, "Gen-Hu-Obj")
    assert jids == pids
    return jt, pt, dict(zip(("seg_token_idx", "hseg_token_idx",
                             "oseg_token_idx"), pids))


# the dataset cases: (class, constructor keywords, records to append)
MISSING = {"image": "chair_001.jpg", "object_id": "gone_000",
           "class_name": "Chair", "affordance": "sit"}
CASES = {
    "oafford-train": ("OAffordDataset", dict(split="train"), []),
    "oafford-train-afford": ("OAffordDataset",
                             dict(split="train", question_type="afford"),
                             [dict(MISSING, object_matches=["gone_000"])]),
    "oafford-random-ranking": ("OAffordDataset",
                               dict(split="train", object_ranking="random"),
                               []),
    "oafford-test-retry": ("OAffordDataset", dict(split="test"), [MISSING]),
    "ocontact-retry": ("OContactDataset", dict(split="train"),
                       [{"image": "mug_img.jpg", "object_id": "gone_000",
                         "class_name": "Mug"}]),
    "ocontact-test": ("OContactDataset", dict(split="test",
                                              max_vertices=256), []),
    "vqa": ("VQADataset", dict(), []),
    "h2dcontact": ("H2DContactDataset", dict(split="test"), []),
}


@pytest.mark.parametrize("side", ["jax", "port"], ids=["jax_tree",
                                                        "port_tree"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dataset_samples_equal(trees, case, side):
    cls, kw, extra = CASES[case]
    kw = dict(kw, image_size=S, clip_size=28)
    if cls in ("OAffordDataset", "OContactDataset"):
        kw["view_type"] = OBJECT
    if cls == "OAffordDataset":
        kw["num_points"] = N_POINTS
    jd = getattr(JD, cls)(trees[side], **kw)
    td = getattr(TD, cls)(trees[side], **kw)
    for ds in (jd, td):
        ds.samples = list(getattr(ds, "samples", getattr(ds, "records", [])))
        ds.samples += extra
        if cls == "VQADataset":
            ds.records = ds.samples
    assert len(td) == len(jd) > 0
    for rep in range(2):
        for i in range(len(td)):
            a, b = td[i], jd[i]
            assert_object_samples_equal(a, b)
            assert td.rng.getstate() == jd.rng.getstate()
    if cls == "OAffordDataset" and kw["split"] == "train":
        # the zero-contact mug is never the chosen object of a train row
        assert all("mug_002" not in m for m in
                   (td[i].mask_paths[0] for i in range(len(td))))


def test_vqa_per_split_and_sizes(tmp_path):
    root = str(tmp_path)
    os.makedirs(join(root, "images"))
    Image.fromarray(np.zeros((9, 7, 3), np.uint8)).save(
        join(root, "images", "q.jpg"))
    rec = {"image": "q.jpg", "question": "Is it?", "answer": "yes ."}
    with open(join(root, "vqa.pkl"), "wb") as f:
        pickle.dump({"train": [rec], "val": [rec, rec]}, f)
    for split, n in (("train", 1), ("val", 2)):
        kw = dict(image_size=S, clip_size=28, split=split)
        jd, td = JD.VQADataset(root, **kw), TD.VQADataset(root, **kw)
        assert len(td) == len(jd) == n
        assert_samples_equal(td[0], jd[0])
    # at another size the row's SAM image and IGNORE masks follow it, so
    # that it stacks with the contact rows (the JAX package's stay 64^2)
    s = TD.VQADataset(root, image_size=96, clip_size=28, split="val")[1]
    assert s.sam_images.shape == (1, 96, 96, 3) and not s.sam_images.any()
    assert s.masks.shape == (1, 96, 96)
    assert (s.masks == TK.IGNORE_LABEL).all()


def test_build_dataset_with_the_flagship_arguments(trees):
    tree = trees["port"]
    args = flagship_args(tree)
    for name in ("hcontact", "ocontact", "oafford", "vqa"):
        jd = JD.build_dataset(name, tree, "train", args)
        td = TD.build_dataset(name, tree, "train", args)
        assert type(td).__name__ == type(jd).__name__
        assert td.view_set.key == jd.view_set.key
        for attr in ("question_type", "num_points", "max_vertices",
                     "num_vertices"):
            assert getattr(td, attr, None) == getattr(jd, attr, None), attr
        for i in range(min(3, len(td))):
            assert_object_samples_equal(td[i], jd[i])
    assert TD.build_dataset("oafford", tree, "train", args).view_set.key \
        == OBJECT
    assert TD.build_dataset("hcontact", tree, "train", args).view_set.key \
        == HUMAN
    # ocontact keeps its own mesh views unless a BM view type is named
    hm = flagship_args(tree, "--oC_sam_view_type", "4MV-Z_HM")
    assert TD.build_dataset("ocontact", tree, "train", hm).view_set.key == \
        JD.build_dataset("ocontact", tree, "train", hm).view_set.key
    fixed = flagship_args(tree, "--fixed_templates")
    for name in ("ocontact", "oafford", "h2dcontact"):
        ds = TD.build_dataset(name, tree, "train", fixed)
        assert isinstance(ds.rng, TD.TemplateFixedRandom)
    for mod in (JD, TD):
        with pytest.raises(ValueError, match="fixed_templates"):
            mod.build_dataset("vqa", tree, "train", fixed)
    assert TD.FIXED_TEMPLATE_SAFE == JD.FIXED_TEMPLATE_SAFE
    assert set(TD.DATASET_REGISTRY) == set(JD.DATASET_REGISTRY)


def _human_maps(tree):
    m = np.load(join(tree, "hcontact_vitruvian_mv2", "lift_maps.npz"))
    return {k: np.ascontiguousarray(np.moveaxis(m[k], -1, 0))
            for k in ("p2v", "bary")}


def test_hybrid_picks_and_a_mixed_batch_collate_equal(trees):
    tree = trees["port"]
    args = flagship_args(tree)
    names = args.dataset.split("||")
    jds = [JD.build_dataset(n, tree, "train", args) for n in names]
    tds = [TD.build_dataset(n, tree, "train", args) for n in names]
    jh = JD.HybridDataset(jds, [9, 9, 5, 2], samples_per_epoch=32)
    th = TD.HybridDataset(tds, [9, 9, 5, 2], samples_per_epoch=32)
    kinds = set()
    for i in range(16):
        a, b = th[i], jh[i]
        assert_object_samples_equal(a, b)
        kinds.add(a.ds_name)
    assert kinds == {"hcontact", "ocontact", "oafford", "vqa"}
    # one batch of every kind, K = 2 slots, object maps on
    js = [d[0] for d in jds] + [jds[2][1]]
    ts = [d[0] for d in tds] + [tds[2][1]]
    jt, pt, _ = tokenizers()
    kw = dict(max_len=384, num_human_vertices=178,
              num_object_points=N_POINTS, max_seg_tokens=2,
              include_object_maps=True, human_maps=_human_maps(tree))
    want, wmeta = JC.collate(js, jt, **kw)
    got, gmeta = TC.collate(ts, pt, **kw)
    assert_batches_equal(got, want)
    assert sorted(gmeta["ds_name_list"]) == sorted(wmeta["ds_name_list"])
    assert got["task_ids"].tolist() == [2, 4, 3, 0, 3]
    assert (got["obj_p2p"][2] >= 0).any() and (got["obj_p2v"][:, 1] >= 0
                                               ).any()
    assert (got["gt_masks"][3] == TK.IGNORE_LABEL).all()


def _real_batches(tree, n, side, batch_size=4):
    argv = ["--batch_size", str(batch_size), "--data_workers", "1",
            "--prefetch_depth", "1", "--steps_per_epoch", "2"]
    args = flagship_args(tree, *argv)
    cfg = Namespace(num_human_vertices=178, num_object_points=N_POINTS,
                    max_seg_tokens=2)
    jt, pt, _ = tokenizers()
    it = (TTR.real_batch_iter(args, cfg, pt) if side == "port"
          else JTR.real_batch_iter(args, cfg, jt))
    out = [next(it) for _ in range(n)]
    if side == "port":
        it.close()
    return args, out


def test_real_batch_iter_first_two_flagship_batches_equal(trees):
    tree = trees["port"]
    _, want = _real_batches(tree, 2, "jax")
    _, got = _real_batches(tree, 2, "port")
    for g, w in zip(got, want):
        assert_batches_equal(g, {k: np.asarray(v) for k, v in w.items()})
    assert {"obj_p2p", "obj_p2v", "gt_ocontact", "seg_slot_has_mask",
            "human_p2v"} <= set(got[0])


def _np(tree):
    return jax.tree.map(np.array, nn.meta.unbox(tree))


def test_train_step_on_the_first_flagship_batch_matches_jax(trees):
    from interactvlm_tpu.parallel.mesh import create_mesh
    from interactvlm_tpu.train.optimizer import make_optimizer as jax_opt
    from interactvlm_tpu.train.optimizer import trainable_mask
    from interactvlm_tpu.train.train_step import (
        create_sharded_state,
        make_train_step,
    )

    tree = trees["port"]
    _, _, token_kw = tokenizers()
    # the first batch of 8 holds rows of all four datasets
    args, (jbatch,) = _real_batches(tree, 1, "jax", batch_size=8)
    _, (tbatch,) = _real_batches(tree, 1, "port", batch_size=8)
    assert set(np.asarray(jbatch["task_ids"]).tolist()) == {0, 2, 3, 4}
    jm, jcfg = JTR.build_model_and_config(args, **token_kw)
    mesh = create_mesh(n_data=1, n_model=1, devices=jax.devices()[:1])
    tx, _ = jax_opt(lr=1e-3, warmup_steps=0, total_steps=10,
                    mask=trainable_mask)
    with mesh:
        state, shardings = create_sharded_state(jm, tx, jbatch, mesh)
        params = _np(state.params)
        # seeded non-zero LoRA B factors (init draws them zero)
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
    assert jmetrics["hC_loss"] > 0 and jmetrics["oC_loss"] > 0
    assert jmetrics["oA_loss"] > 0
    for k in LOSS_KEYS + ("grad_norm",):
        np.testing.assert_allclose(m[k].item(), jmetrics[k], rtol=STEP_RTOL,
                                   atol=1e-7, err_msg=k)


def test_tiny_flagship_through_the_train_and_eval_clis(trees, tmp_path):
    tree, runs = trees["port"], str(tmp_path / "runs")
    trainer = TTR.main(TINY + FLAGSHIP + [
        "--dataset_dir", tree, "--epochs", "1", "--steps_per_epoch", "2",
        "--batch_size", "4", "--lr", "1e-3", "--warmup_steps", "1",
        "--log_base_dir", runs, "--exp_name", "flagship",
        "--val_batches", "1", "--data_workers", "2", "--no_tensorboard",
        "--device", "cpu"])
    run = join(runs, "flagship")
    assert trainer.step.step == 2 and trainer.cfg.max_seg_tokens == 2
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert CheckpointManager(run).steps() == [2]
    reports = {}
    for name, metric in (("ocontact", "f1"), ("oafford", "auc")):
        reports[name] = TE.main(["--run_dir", run, "--dataset_dir", tree,
                                 "--val_dataset", name, "--batch_size", "2",
                                 "--max_batches", "1", "--max_new_tokens",
                                 "8", "--device", "cpu"])
        assert np.isfinite(reports[name]["metrics"][metric]), name
    assert {"sim", "mae", "auc", "aiou"} <= set(reports["oafford"]["metrics"])
    assert {"f1", "precision", "recall"} <= set(
        reports["ocontact"]["metrics"])


def test_kslot_oafford_lifts_through_the_point_maps(trees):
    """A K = 2 model's oafford answers lift through the per-sample point
    maps, as the one-token path and the JAX package's point lift do, even
    though a collated object batch also carries mesh maps (the JAX
    package's K-slot path lifts through those: ROADMAP Queue C)."""
    from interactvlm_tpu.geometry.lift import lift_multiview_points

    from interactvlm_tpu_torch.utils.weights import init_params

    tree = trees["port"]
    args = flagship_args(tree)
    _, pt, token_kw = tokenizers()
    tm, _ = TTR.build_model_and_config(args, device="cpu", **token_kw)
    init_params(tm, torch.Generator().manual_seed(0))
    oseg = token_kw["oseg_token_idx"]
    with torch.no_grad():  # every answer token [OSEG]
        tm.llava.lm.model.embed_tokens.weight[:, 0] = 30.0
        tm.llava.mm_projector.bias[0] = 30.0
        tm.llava.lm.lm_head.weight[oseg, 0] = 5.0
    ds = TD.ValDataset(TD.build_dataset("oafford", tree, "test", args))
    batch, _ = TC.collate([ds[i] for i in range(3)], pt, max_len=384,
                          num_human_vertices=178,
                          num_object_points=N_POINTS,
                          include_object_maps=True)
    assert "obj_p2v" in batch and "gt_ocontact" in batch
    out = TE.evaluate_batch(tm, batch, S, "oafford", max_new_tokens=4,
                            max_seg_tokens=2)
    assert out["valid_k"].all() and (out["token_ids_k"] == oseg).all()
    got = out["pred_contact_3d"]
    assert tuple(got.shape) == (3, N_POINTS) and float(got.max()) > 0
    masks = out["pred_masks_k"][:, 0].float().numpy()
    want = np.stack([np.asarray(lift_multiview_points(
        jax.nn.sigmoid(jnp.asarray(m)), jnp.asarray(p), N_POINTS))
        for m, p in zip(masks, batch["obj_p2p"].numpy())])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    res, _ = TE.validate(iter([(batch, {"image_paths": [], "sampled_"
                                        "classes_list": []})]), tm,
                         "oafford", S, max_new_tokens=4)
    assert res["seg_rate"] == 1.0 and np.isfinite(res["auc"])


# ------------------------------------------- departures from the JAX package
# ROADMAP Queue C: where the JAX package returns a result, the port returns
# the same; where it raises, the port may return one, and a test pins the
# difference. These two run the JAX pipeline and the port on one input.
def test_vqa_rows_collate_at_1024_where_the_jax_package_raises(tmp_path):
    """A VQA row beside a contact row at 1024^2: the JAX ``VQADataset``'s
    masks are 64^2 whatever ``image_size`` is, so its ``collate`` raises
    stacking them; the port's are ``image_size`` square, and its collate
    returns the batch, the VQA row's masks all IGNORE."""
    import dataclasses

    root, S, V = str(tmp_path), 1024, 4
    os.makedirs(join(root, "images"))
    Image.fromarray(np.zeros((9, 7, 3), np.uint8)).save(
        join(root, "images", "q.jpg"))
    rec = {"image": "q.jpg", "question": "Is it?", "answer": "yes ."}
    with open(join(root, "vqa.pkl"), "wb") as f:
        pickle.dump({"train": [rec], "val": [rec]}, f)
    kw = dict(image_size=S, clip_size=28, split="val")
    batches = {}
    for side, D, C, tok in (("jax", JD, JC, JaxTok(384)),
                            ("port", TD, TC, PortTok(384))):
        vqa = D.VQADataset(root, **kw)[0]
        contact = dataclasses.replace(
            vqa, masks=np.zeros((V, S, S), np.float32),
            sam_images=np.zeros((V, S, S, 3), np.float32),
            cam_params=np.zeros((V, 5), np.float32), ds_name="hcontact",
            gt_contact_3d=np.zeros(178, np.float32))
        try:
            batches[side] = C.collate([contact, vqa], tok, max_len=384,
                                      num_human_vertices=178)[0]
        except ValueError as e:
            batches[side] = e
    assert isinstance(batches["jax"], ValueError)
    gt = np.asarray(batches["port"]["gt_masks"])
    assert gt.shape == (2, V, S, S)
    assert (gt[1] == TK.IGNORE_LABEL).all() and (gt[0] == 0).all()


def test_kslot_oafford_metrics_return_where_the_jax_package_raises(trees):
    """One collated oafford batch (it also carries the object mesh maps) and
    one generation whose answers are all [OSEG], through the JAX package's
    and the port's ``_evaluate_batch_multiseg`` on the same weights: the
    JAX one lifts the [OSEG] slots through ``obj_p2v`` onto the mesh's
    ``max_object_vertices``, so ``affordance_metrics`` raises against the
    ``num_object_points`` targets; the port lifts through ``obj_p2p`` and
    the metrics return, finite."""
    from interactvlm_tpu.eval import evaluate as JE
    from interactvlm_tpu.eval import metrics as JMET

    from interactvlm_tpu_torch.eval import metrics as TMET

    tree = trees["port"]
    args = flagship_args(tree)
    jt, pt, token_kw = tokenizers()
    jm, jcfg = JTR.build_model_and_config(args, **token_kw)
    ds_j = JD.ValDataset(JD.build_dataset("oafford", tree, "test", args))
    ds_t = TD.ValDataset(TD.build_dataset("oafford", tree, "test", args))
    kw = dict(max_len=384, num_human_vertices=178,
              num_object_points=N_POINTS, include_object_maps=True,
              max_seg_tokens=2)
    jb, _ = JC.collate([ds_j[i] for i in range(2)], jt, **kw)
    tb, _ = TC.collate([ds_t[i] for i in range(2)], pt, **kw)
    params = jax.tree.map(np.array, nn.meta.unbox(jax.jit(jm.init)(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in jb.items()})))
    oseg, T, K = token_kw["oseg_token_idx"], 3, 2
    gen = np.full((2, T), oseg, np.int32)
    hidden = np.random.default_rng(0).standard_normal(
        (2, T, jcfg.llama.hidden_size)).astype(np.float32)
    jout = JE._evaluate_batch_multiseg(
        jm, params, {k: jnp.asarray(v) for k, v in jb.items()}, jcfg, S,
        gen, gen == oseg, hidden, np.ones(2, bool), K, None, None, None,
        "oafford")
    assert jout["pred_contact_3d"].shape[1] != N_POINTS
    with pytest.raises(ValueError):
        JMET.affordance_metrics(np.asarray(jb["gt_oafford"]),
                                jout["pred_contact_3d"])

    tm, _ = TTR.build_model_and_config(args, device="cpu", **token_kw)
    tm.load_state_dict(from_jax_params(params), strict=False)
    g = torch.from_numpy(gen)
    with torch.inference_mode():
        tout = TE._evaluate_batch_multiseg(
            tm, tb, S, g, g == oseg, torch.from_numpy(hidden), K, None,
            None, None, "oafford")
    pred = tout["pred_contact_3d"].numpy()
    assert pred.shape == (2, N_POINTS)
    metrics = TMET.affordance_metrics(tb["gt_oafford"].numpy(), pred)
    assert all(np.isfinite(v) for v in metrics[:4])
