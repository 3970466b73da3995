"""The port's entry points against the JAX package's, on the CPU, at tiny size:
``merge_lora``, ``validate`` (both inference types), one ``TrainStep`` on
the first real batch, the eval CLI on run directories holding the same
weights, and the port's train CLI on its own (a smoke run, resume, the
best gate's tie rule, export then eval), the checkpoints and the profiler.

The fixture tree is the JAX recipe's DAMON tree (``tests/test_torch_data.py
:make_damon_tree``); the model is the train CLI's ``--model_scale tiny``
build with the whitespace tokenizer ([SEG] = 4), initialised once by JAX
and carried to the port by ``from_jax_params``. Random weights almost never
emit [SEG]: the answers are forced to it through the residual stream (a
constant channel 0 and [SEG]'s lm_head weight on it, as
``tests/test_torch_multiseg.py`` forces them), so every row decodes a mask.

Tolerances (f32 on both sides, differing in summation order through LLaMA,
SAM, the upsampling and the lifts' scatters):
- generated ids identical; mask logits within 1e-4 absolute and relative;
  lifted contacts within 1e-3 (the JAX package's test bound for the lift);
- the metrics of ``validate`` and the eval CLI's report within 1e-6: the
  contacts' differences (at most 1e-5 here) flip no vertex across the 0.5
  threshold and no mask pixel across 0 on these inputs, so the thresholded
  metrics come out equal up to float summation;
- the training step's loss and each part within 1e-4 relative, its
  gradient norm too (``tests/test_torch_train.py``'s step tolerance);
- ``merge_lora``: within f32 rounding of the merged weight (1e-6 relative
  and absolute).
"""

import json
import os
from argparse import Namespace

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interactvlm_tpu.data import collate as JC
from interactvlm_tpu.data import datasets as JD
from interactvlm_tpu.eval import evaluate as JE
from interactvlm_tpu.train import train as JTR
from interactvlm_tpu.utils import constants as JK
from interactvlm_tpu.utils.testing import WhitespaceTokenizer as JaxTok
from interactvlm_tpu.utils.testing import make_synthetic_batch as jax_batch
from interactvlm_tpu.utils.weights import merge_lora as jax_merge_lora
from interactvlm_tpu_torch.data import collate as TC
from interactvlm_tpu_torch.data import datasets as TD
from interactvlm_tpu_torch.eval import evaluate as TE
from interactvlm_tpu_torch.train import train as TTR
from interactvlm_tpu_torch.train.checkpoints import (
    CheckpointManager,
    load_config,
    save_config,
)
from interactvlm_tpu_torch.train.export import main as export_main
from interactvlm_tpu_torch.train.optimizer import make_optimizer
from interactvlm_tpu_torch.train.train_step import TrainStep
from interactvlm_tpu_torch.utils import constants as TK
from interactvlm_tpu_torch.utils.testing import WhitespaceTokenizer as PortTok
from interactvlm_tpu_torch.utils.weights import from_jax_params, merge_lora

from tests.test_torch_data import make_damon_tree

S, MASK_TOL, LIFT_TOL, METRIC_TOL, STEP_RTOL = 64, 1e-4, 1e-3, 1e-6, 1e-4
SEG = 4  # [SEG] of the whitespace tokenizer (its first added token)
LOSS_KEYS = ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
             "mask_l2_loss", "mask_loss", "hC_loss", "oA_loss", "oC_loss")


def cli_args(tree, **kw):
    argv = ["--tokenizer", "whitespace", "--model_scale", "tiny",
            "--dataset", "hcontact", "--dataset_dir", tree,
            "--hC_question_type", "parts", "--fixed_templates",
            "--image_size", str(S), "--clip_size", "28",
            "--num_human_vertices", "178", "--model_max_length", "384",
            "--batch_size", "2", "--data_workers", "1", "--no_tensorboard"]
    for k, v in kw.items():
        argv += [f"--{k}"] + ([] if v is True else [str(v)])
    return argv


def _np(tree):
    return jax.tree.map(np.array, nn.meta.unbox(tree))


def force_seg(tree):
    """Every answer's tokens become [SEG]: a large constant channel 0 in
    the residual stream (the embeddings and the projected patches) and
    [SEG]'s lm_head weight on it."""
    tree = jax.tree.map(np.array, tree)
    p = tree["params"]["llava"]
    p["lm"]["model"]["embed_tokens"]["embedding"][:, 0] = 30.0
    p["mm_projector"]["bias"][0] = 30.0
    head = p["lm"]["lm_head"]["kernel"]
    head[0, SEG] = 5.0
    return tree


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("clis"))
    tree_dir = os.path.join(root, "data")
    make_damon_tree(tree_dir, n_images=4)
    args = JTR.parse_args(cli_args(tree_dir))
    token_kw = dict(seg_token_idx=SEG, hseg_token_idx=SEG, oseg_token_idx=SEG)
    jm, jcfg = JTR.build_model_and_config(args, **token_kw)
    example = jax_batch(jcfg, B=2, mask_size=32)
    params = _np(jax.jit(jm.init)(jax.random.PRNGKey(0), example))
    # seeded non-zero LoRA B factors (init draws them zero)
    rng = np.random.default_rng(0)
    for name, layer in params["params"]["llava"]["lm"]["model"].items():
        if name.startswith("layer_"):
            for proj in ("q_proj", "v_proj"):
                b = layer["self_attn"][proj]["lora_b"]
                b[...] = rng.standard_normal(b.shape).astype(np.float32) * .05
    forced = force_seg(params)
    return dict(root=root, tree=tree_dir, args=args, token_kw=token_kw,
                jm=jm, jcfg=jcfg, params=params, forced=forced)


@pytest.fixture(scope="module")
def jax_run(setup, tmp_path_factory):
    """A JAX run directory holding the forced weights, and those weights
    restored from it as the JAX eval CLI restores them (so the JAX side's
    compiled generation is shared by the tests that use them)."""
    from interactvlm_tpu.train import checkpoints as jax_ckpt
    from interactvlm_tpu.train.optimizer import make_optimizer as jax_opt
    from interactvlm_tpu.train.optimizer import trainable_mask
    from interactvlm_tpu.train.train_step import TrainState

    jrun = str(tmp_path_factory.mktemp("jax_run"))
    jax_ckpt.save_config(jrun, {**vars(setup["args"]), **setup["token_kw"]},
                         "pretrained_config.json")
    tx, _ = jax_opt(mask=trainable_mask)
    jparams = jax.tree.map(jnp.asarray, setup["forced"])
    ckpt = jax_ckpt.CheckpointManager(jrun)
    ckpt.save(3, TrainState(step=jnp.int32(3), params=jparams,
                            opt_state=tx.init(jparams)))
    example = jax_batch(setup["jcfg"], B=2, mask_size=setup["args"].mask_size)
    abstract = jax.eval_shape(lambda: nn.meta.unbox(
        setup["jm"].init(jax.random.PRNGKey(0), example)))
    state = ckpt.restore(TrainState(
        step=jax.ShapeDtypeStruct((), "int32"), params=abstract,
        opt_state=jax.eval_shape(tx.init, abstract)))
    return jrun, state.params


def port_model(setup, params):
    tm, cfg = TTR.build_model_and_config(
        TTR.parse_args(cli_args(setup["tree"])), device="cpu",
        **setup["token_kw"])
    missing, unexpected = tm.load_state_dict(from_jax_params(params),
                                             strict=False)
    assert not unexpected and all("mask_downscaling" in k for k in missing)
    return tm


def _tokenizers():
    jt, pt = JaxTok(384), PortTok(384)
    JK.add_new_tokens(jt, "Gen")
    TK.add_new_tokens(pt, "Gen")
    return jt, pt


def _maps(tree):
    m = np.load(os.path.join(tree, "hcontact_vitruvian_mv2", "lift_maps.npz"))
    return {k: np.ascontiguousarray(np.moveaxis(m[k], -1, 0))
            for k in ("p2v", "bary")}


def val_batches(setup, B=2, n=2):
    """The eval CLI's batches, built by both packages from the tree."""
    args, tree = setup["args"], setup["tree"]
    jds = JD.ValDataset(JD.build_dataset("hcontact", tree, "test", args))
    tds = TD.ValDataset(TD.build_dataset("hcontact", tree, "test", args))
    jt, pt = _tokenizers()
    maps = _maps(tree)
    kw = dict(max_len=384, num_human_vertices=178,
              num_object_points=setup["jcfg"].num_object_points,
              human_maps=maps)
    jb = [JC.collate([jds[i] for i in range(k * B, k * B + B)], jt, **kw)
          for k in range(n)]
    tb = [TC.collate([tds[i] for i in range(k * B, k * B + B)], pt, **kw)
          for k in range(n)]
    return jb, tb, maps


# ------------------------------------------------------------- weights
def test_merge_lora_matches_jax(setup):
    params = setup["params"]
    rank, alpha = setup["jcfg"].llama.lora_rank, setup["jcfg"].llama.lora_alpha
    want = from_jax_params({"params": jax_merge_lora(params["params"], alpha,
                                                     rank)})
    got = merge_lora(from_jax_params(params), alpha, rank)
    assert set(got) == set(want)
    assert not any("lora_" in k for k in got)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    # the merged weights load into the same model without LoRA
    cfg = TTR.build_config(TTR.parse_args(cli_args(setup["tree"], lora_r=0)),
                           device="cpu", **setup["token_kw"])
    from interactvlm_tpu_torch.models.interactvlm import InteractVLM

    missing, unexpected = InteractVLM(cfg, device="cpu").load_state_dict(
        got, strict=False)
    assert not unexpected and all("mask_downscaling" in k for k in missing)


# ------------------------------------------------------------- validate
def test_evaluate_batch_and_validate_match_jax(setup, jax_run):
    jm, jcfg = setup["jm"], setup["jcfg"]
    tm = port_model(setup, setup["forced"])
    forced = jax_run[1]  # the same weights, as the JAX eval CLI holds them
    jb, tb, maps = val_batches(setup)
    hm = {**maps, "num_vertices": 178}
    # one batch through evaluate_batch: ids, masks and lifted contacts
    want = JE.evaluate_batch(jm, forced, jb[0][0], jcfg, S,
                             max_new_tokens=8, human_maps=hm)
    got = TE.evaluate_batch(tm, tb[0][0], S, max_new_tokens=8,
                            human_maps=hm)
    np.testing.assert_array_equal(got["generated_ids"].numpy(),
                                  want["generated_ids"])
    assert got["has_seg"].all() and want["has_seg"].all()
    np.testing.assert_allclose(got["pred_masks"].numpy(), want["pred_masks"],
                               rtol=MASK_TOL, atol=MASK_TOL)
    np.testing.assert_allclose(got["pred_contact_3d"].numpy(),
                               want["pred_contact_3d"], atol=LIFT_TOL)
    for itype, cached in (("generate", True), ("forward", False)):
        if True:
            jres, jsaved = JE.validate(
                iter(jb), jm, forced, jcfg, "hcontact", S,
                inference_type=itype, human_maps=hm, max_new_tokens=8,
                cache_view_encode=cached)
            tres, tsaved = TE.validate(
                iter(tb), tm, "hcontact", S, inference_type=itype,
                human_maps=hm, max_new_tokens=8, cache_view_encode=cached)
            assert tres.keys() == jres.keys()
            for k in jres:
                assert abs(tres[k] - jres[k]) <= METRIC_TOL, (itype, k)
            if itype == "generate":
                assert tres["seg_rate"] == 1.0
            assert len(tsaved["pred"]) == len(jsaved["pred"]) == 4
            for a, b in zip(tsaved["pred"], jsaved["pred"]):
                np.testing.assert_array_equal(a, b)
            assert tsaved["imgnames"] == jsaved["imgnames"]
            assert tsaved["objnames"] == jsaved["objnames"]


def test_validate_scores_lisa_rows_as_jax(setup, jax_run, tmp_path):
    """``validate`` on ReasonSeg val rows (a 2D task: gIoU and cIoU of
    the masks in the photo's own frame, one view repeated to V) against
    the JAX package's, from the forced weights, both inference types; the
    REFER rows in the forward type."""
    from interactvlm_tpu_torch.utils.lisa_tree import write_lisa_tree

    lisa = str(tmp_path / "lisa")
    write_lisa_tree(lisa, n_ade=2, n_refcoco=2, n_reason=4, n_vqa=1,
                    scale=1 / 16)
    args = JTR.parse_args([a for a in cli_args(lisa)
                           if a != "--fixed_templates"])
    jm, jcfg = setup["jm"], setup["jcfg"]
    tm = port_model(setup, setup["forced"])
    forced = jax_run[1]
    jt, pt = _tokenizers()
    for name in ("reason_seg", "refer_seg_lisa"):
        jds = JD.ValDataset(JD.build_dataset(name, lisa, "val", args))
        tds = TD.ValDataset(TD.build_dataset(name, lisa, "val", args))
        jb = JC.collate([jds[i % len(jds)] for i in range(2)], jt,
                        max_len=384)
        tb = TC.collate([tds[i % len(tds)] for i in range(2)], pt,
                        max_len=384)
        assert tb[0]["task_ids"].tolist() == [1, 1]
        types = ("generate", "forward") if name == "reason_seg" else (
            "forward",)
        for itype in types:
            jres, _ = JE.validate(iter([jb]), jm, forced, jcfg, name, S,
                                  inference_type=itype, max_new_tokens=8)
            tres, _ = TE.validate(iter([tb]), tm, name, S,
                                  inference_type=itype, max_new_tokens=8)
            assert tres.keys() == jres.keys() >= {"giou", "ciou"}
            for k in jres:
                assert abs(tres[k] - jres[k]) <= METRIC_TOL, (name, itype, k)
            if itype == "generate":
                assert tres["seg_rate"] == 1.0


def test_validate_warns_on_ocontact_without_targets(setup):
    tm = port_model(setup, setup["params"])
    _, tb, _ = val_batches(setup, n=1)
    with pytest.warns(UserWarning, match="gt_ocontact"):
        TE.validate(iter(tb), tm, "ocontact", S, inference_type="forward",
                    max_new_tokens=2)


# ------------------------------------------------------------- training
def test_train_step_on_the_first_real_batch_matches_jax(setup):
    from interactvlm_tpu.parallel.mesh import create_mesh
    from interactvlm_tpu.train.optimizer import make_optimizer as jax_opt
    from interactvlm_tpu.train.optimizer import trainable_mask
    from interactvlm_tpu.train.train_step import (
        create_sharded_state,
        make_train_step,
    )

    jm, params = setup["jm"], setup["params"]
    args = setup["args"]
    jt, pt = _tokenizers()
    jbatch = next(JTR.real_batch_iter(args, setup["jcfg"], jt))
    tm = port_model(setup, params)
    tbatch = next(TTR.real_batch_iter(args, tm.config, pt))
    for k in jbatch:
        np.testing.assert_array_equal(tbatch[k].numpy(), np.asarray(jbatch[k]),
                                      err_msg=k)
    mesh = create_mesh(n_data=1, n_model=1, devices=jax.devices()[:1])
    tx, _ = jax_opt(lr=1e-3, warmup_steps=0, total_steps=10,
                    mask=trainable_mask)
    with mesh:
        state, shardings = create_sharded_state(jm, tx, jbatch, mesh)
        state = state.replace(params=jax.tree.map(jnp.asarray, params),
                              opt_state=tx.init(params))
        step = make_train_step(jm, tx, mesh, shardings, jbatch, donate=False)
        _, jmetrics = step(state, jbatch)
        jmetrics = jax.tree.map(float, jmetrics)
    opt, sched = make_optimizer(tm, lr=1e-3, warmup_steps=0, total_steps=10)
    m = TrainStep(tm, opt, sched)(tbatch)
    assert jmetrics["hC_loss"] > 0 and jmetrics["mask_loss"] > 0
    for k in LOSS_KEYS + ("grad_norm",):
        np.testing.assert_allclose(m[k].item(), jmetrics[k], rtol=STEP_RTOL,
                                   atol=1e-7, err_msg=k)


# ------------------------------------------------------------- eval CLI
def test_eval_cli_matches_jax_on_the_same_weights(setup, jax_run, tmp_path):
    forced, args = setup["forced"], setup["args"]
    conf = {**vars(args), **setup["token_kw"]}
    jrun, trun = jax_run[0], str(tmp_path / "port_run")
    save_config(trun, conf, "pretrained_config.json")
    tm = port_model(setup, forced)
    CheckpointManager(trun).save(3, {"model": tm.state_dict(), "step": 3})
    argv = ["--dataset_dir", setup["tree"], "--batch_size", "2",
            "--max_batches", "2", "--max_new_tokens", "8"]
    want = JE.main(["--run_dir", jrun] + argv)
    got = TE.main(["--run_dir", trun, "--device", "cpu",
                   "--out", str(tmp_path / "report.json")] + argv)
    assert got["metrics"]["seg_rate"] == want["metrics"]["seg_rate"] == 1.0
    assert got.keys() == want.keys()
    for part in want:
        for k, v in want[part].items():
            assert abs(got[part][k] - v) <= METRIC_TOL, (part, k)
    with open(tmp_path / "report.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))


def test_unported_options_raise_with_their_roadmap_item(setup, tmp_path):
    """The distributed options in one plain process say how to launch
    them, and the LISA datasets, which raised until the port had them,
    train through the CLI."""
    # the distributed options run under a launcher (tests/
    # test_torch_distributed.py); in one plain process they say how to
    # launch them
    with pytest.raises(ValueError, match="torchrun"):
        TTR.main(cli_args(setup["tree"], n_model_shards=2, device="cpu",
                          log_base_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="torchrun"):
        TE.main(["--run_dir", str(tmp_path), "--distributed",
                 "--device", "cpu"])
    # the LISA datasets, which raised until the port had them, train:
    # LISA's own mixture takes a step with three conversations a row
    from interactvlm_tpu_torch.utils.lisa_tree import write_lisa_tree

    lisa = str(tmp_path / "lisa")
    write_lisa_tree(lisa, n_ade=3, n_refcoco=2, n_reason=3, n_vqa=2,
                    scale=1 / 16)
    argv = [a for a in cli_args(
        lisa, dataset="sem_seg_lisa||refer_seg_lisa||vqa||reason_seg",
        sample_rates="9,3,3,1", num_conversations=3, epochs=1,
        steps_per_epoch=1, no_eval=True, device="cpu",
        log_base_dir=str(tmp_path / "runs")) if a != "--fixed_templates"]
    trainer = TTR.main(argv)
    (h,) = trainer.history
    assert np.isfinite(h["loss"]) and h["skipped_nonfinite"] == 0.0
    assert sum(h["rows_by_task"].values()) > 0


# ------------------------------------------------------------- port CLIs
def test_train_cli_smoke_resume_export_and_eval(setup, tmp_path):
    runs = str(tmp_path / "runs")
    common = cli_args(setup["tree"], steps_per_epoch=2, lr="1e-3",
                      warmup_steps=1, val_batches=1, log_base_dir=runs,
                      exp_name="chain", device="cpu", profile_steps=1)
    trainer = TTR.main(common + ["--epochs", "2"])
    run = os.path.join(runs, "chain")
    assert trainer.step.step == 4 and len(trainer.history) == 4
    assert all(0 <= h["loader_wait_share"] < 1 for h in trainer.history)
    for f in ("config.json", "pretrained_config.json", "metrics.jsonl",
              "best_score.json", "profile/trace.json",
              "code_snapshot/interactvlm_tpu_torch/train/train.py"):
        assert os.path.exists(os.path.join(run, f)), f
    assert CheckpointManager(run).steps() == [2, 4]
    assert os.path.exists(os.path.join(run, "ckpt_best", "state.pt"))
    assert not any(p.endswith((".tmp", ".old")) for p in os.listdir(run))
    conf = load_config(run, "pretrained_config.json")
    assert conf["seg_token_idx"] == SEG and conf["tokenizer"] == "whitespace"
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    assert any("val/f1" in r for r in recs) and any("loss" in r for r in recs)

    resumed = TTR.main(common + ["--epochs", "3", "--resume"])
    assert resumed.step.step == 6 and len(resumed.history) == 2
    assert resumed.history[0]["epoch"] == 2
    assert CheckpointManager(run).steps() == [4, 6]  # keeps two
    # Adam's moments and the schedule went on from the checkpoint
    adam = resumed.optimizer.state_dict()["state"]
    assert {float(v["step"]) for v in adam.values()} == {6.0}
    assert resumed.scheduler.last_epoch == 6
    conf = load_config(run, "pretrained_config.json")
    assert conf["resume"] and conf["epochs"] == 3

    out = str(tmp_path / "export")
    sd = export_main(["--run_dir", run, "--out_dir", out])
    assert not any("lora_" in k for k in sd)
    assert os.path.exists(os.path.join(out, "params.pt"))
    assert load_config(out, "pretrained_config.json") == conf
    rep = TE.main(["--run_dir", run, "--dataset_dir", setup["tree"],
                   "--batch_size", "2", "--max_batches", "1",
                   "--max_new_tokens", "4", "--device", "cpu",
                   "--quantize_weights", "--kv_cache", "int8"])
    assert {"f1", "precision", "recall", "giou", "ciou", "seg_rate"} <= set(
        rep["metrics"])
    assert "damon_binary" in rep and "damon_semantic" in rep


def test_train_cli_synthetic_with_accumulation(tmp_path):
    trainer = TTR.main(["--synthetic", "--epochs", "1",
                        "--steps_per_epoch", "2", "--batch_size", "2",
                        "--grad_accumulation_steps", "2", "--device", "cpu",
                        "--log_base_dir", str(tmp_path), "--exp_name", "s",
                        "--no_tensorboard"])
    assert trainer.step.step == 2
    rep = TE.main(["--run_dir", str(tmp_path / "s"), "--synthetic",
                   "--max_batches", "1", "--max_new_tokens", "4",
                   "--device", "cpu"])
    assert "f1" in rep["metrics"] and "damon_binary" in rep


@pytest.mark.parametrize("higher", [True, False])
def test_best_gate_takes_ties_and_honours_the_direction(tmp_path, higher):
    ck = CheckpointManager(str(tmp_path), max_to_keep=2)
    scores = [0.5, 0.5, 0.4, 0.7]
    want = [True, True, not higher, higher]
    for step, (score, w) in enumerate(zip(scores, want)):
        assert ck.save_best(step, {"step": step}, score,
                            higher_is_better=higher) == w
    best = 0.7 if higher else 0.4
    assert ck.best_score == best
    assert CheckpointManager(str(tmp_path)).best_score == best  # persisted
    with open(tmp_path / "best_score.json") as f:
        assert json.load(f)["step"] == (3 if higher else 2)
    assert ck.restore_best()["step"] == (3 if higher else 2)
    assert ck.restore() is None and ck.latest_step() is None
    for step in (5, 9, 7):
        ck.save(step, {"step": step})
    assert ck.steps() == [7, 9] and ck.restore()["step"] == 9
    assert ck.restore(7)["step"] == 7
    assert sorted(os.listdir(tmp_path)) == ["best_score.json", "ckpt",
                                            "ckpt_best"]


def test_config_json_equals_the_jax_packages(tmp_path):
    from interactvlm_tpu.config import interactvlm_tiny as jax_tiny
    from interactvlm_tpu.train import checkpoints as jax_ckpt
    from interactvlm_tpu_torch.config import interactvlm_tiny

    args = vars(JTR.parse_args([]))
    save_config(str(tmp_path / "t"), args, "pretrained_config.json")
    jax_ckpt.save_config(str(tmp_path / "j"), args, "pretrained_config.json")
    assert load_config(str(tmp_path / "t"), "pretrained_config.json") == \
        jax_ckpt.load_config(str(tmp_path / "j"), "pretrained_config.json")
    # every JAX flag exists in the port with the same default
    port = vars(TTR.parse_args([]))
    assert {k: v for k, v in port.items() if k != "device"} == args
    save_config(str(tmp_path / "t"), interactvlm_tiny())
    jax_ckpt.save_config(str(tmp_path / "j"), jax_tiny())
    t, j = (load_config(str(tmp_path / d)) for d in "tj")
    assert t.keys() == j.keys()
    assert t["llama"]["hidden_size"] == j["llama"]["hidden_size"]


def test_profiling_helpers(tmp_path):
    from interactvlm_tpu.utils.profiling import mask_panel as jax_panel
    from interactvlm_tpu_torch.utils.profiling import (
        MetricLogger,
        StepTimer,
        mask_panel,
        profile_trace,
    )

    rng = np.random.default_rng(2)
    parts = (rng.random((28, 28, 3)), rng.normal(size=(64, 64, 3)),
             rng.normal(size=(64, 64)), rng.integers(-1, 2, (64, 64)))
    np.testing.assert_array_equal(mask_panel(*parts), jax_panel(*parts))
    with profile_trace(str(tmp_path / "prof")):
        torch.ones(4).sum()
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    timer = StepTimer()
    timer.mark_data()
    split = timer.mark_step()
    assert split.keys() == {"data_secs", "step_secs"}
    assert split["step_secs"] >= split["data_secs"] >= 0
    logger = MetricLogger(str(tmp_path / "log"))
    logger.log(3, {"loss": torch.tensor(1.5), "skip": "text", "n": 2})
    logger.log_images(3, "panel", mask_panel(*parts))
    logger.close()
    with open(tmp_path / "log" / "metrics.jsonl") as f:
        assert json.loads(f.read()) == {"step": 3, "loss": 1.5, "n": 2.0}
