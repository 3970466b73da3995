"""The port's training and evaluation on several ranks against the JAX
package and against one process, on the CPU: ``TrainStep`` on a
2 x 2 mesh (data parallel, ZeRO-sharded Adam moments, LLaMA tensor-parallel)
against the JAX ``make_train_step``, with accumulation and the NaN guard;
distributed ``validate``; checkpoints between 2 x 2 and one card; the
real loader on two data ranks against one process; the training CLI under
``--n_model_shards 2`` and the eval CLI under ``--distributed``;
``graft_entry_torch.dryrun_multichip(4)``.

Ranks are gloo processes on the CPU (``parallel/launch.py:spawn``, one
thread each, a ``file://`` rendezvous in a fresh temporary directory). The
JAX reference is its step on a 1 x 1 mesh, as ``tests/test_torch_train.py``
builds it: the sharded JAX step equals it by construction (pjit's
partitioning changes no math).

Tolerances (f32 on both sides): per-step losses and gradient norms 1e-4
relative, as ``tests/test_torch_train.py``; parameters after each step
within 2e-3 of the learning rate where the JAX gradient is above its noise
(Adam's first updates are lr * sign(g) there; the gradient at the start is
the port's, which ``tests/test_torch_train.py`` holds against the JAX
package's); against one process, the same; reports equal.
"""

import copy

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interactvlm_tpu.config import interactvlm_tiny as jax_tiny
from interactvlm_tpu.config import llama_tiny as jax_llama_tiny
from interactvlm_tpu.models.interactvlm import InteractVLM as JaxIVLM
from interactvlm_tpu.parallel.mesh import create_mesh
from interactvlm_tpu.train.optimizer import make_optimizer as jax_make_opt
from interactvlm_tpu.train.optimizer import trainable_mask as jax_mask
from interactvlm_tpu.train.train_step import (
    create_sharded_state,
    make_train_step,
)
from interactvlm_tpu.utils.testing import make_synthetic_batch as jax_batch
from interactvlm_tpu_torch.config import interactvlm_tiny, llama_tiny
from interactvlm_tpu_torch.datagen.recipes import (
    generate_damon_tree as port_damon_tree,
)
from interactvlm_tpu_torch.eval.evaluate import main as eval_main
from interactvlm_tpu_torch.eval.evaluate import validate
from interactvlm_tpu_torch.models.interactvlm import InteractVLM
from interactvlm_tpu_torch.parallel.launch import spawn
from interactvlm_tpu_torch.parallel.mesh import Mesh
from interactvlm_tpu_torch.train.optimizer import (
    apply_trainable_mask,
    make_optimizer,
)
from interactvlm_tpu_torch.train.train import main as train_main
from interactvlm_tpu_torch.train.train_step import TrainStep, take_rows
from interactvlm_tpu_torch.utils.testing import make_synthetic_batch
from interactvlm_tpu_torch.utils.weights import from_jax_params, init_params

import graft_entry_torch
from tests import torch_ranks as R
from tests.test_torch_data import S as TREE_SIZE
from tests.test_torch_data import make_damon_tree

MASK, RANK, LR, B, L = 32, 4, 1e-3, 4, 12
NOISE = 1e-7  # gradients at rounding noise, as tests/test_torch_train.py
KEYS = ("loss", "ce_loss", "mask_loss", "hC_loss", "oA_loss", "grad_norm")


def _np(tree):
    return jax.tree.map(np.array, nn.meta.unbox(tree))


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_tiny(llama=jax_llama_tiny(lora_rank=RANK))
    tcfg = interactvlm_tiny(llama=llama_tiny(lora_rank=RANK))
    jb = jax_batch(jcfg, B=B, L=L, mask_size=MASK)
    jm = JaxIVLM(jcfg)
    tree = _np(jax.jit(jm.init)(jax.random.PRNGKey(0), jb))
    rng = np.random.default_rng(0)
    for name, layer in tree["params"]["llava"]["lm"]["model"].items():
        if name.startswith("layer_"):
            for proj in ("q_proj", "v_proj"):
                b = layer["self_attn"][proj]["lora_b"]
                b[...] = rng.standard_normal(b.shape).astype(np.float32) * .05
    # the JAX tree has no mask-downscaling convs (no mask prompt ran): the
    # port's are drawn, one set for every rank and run
    tm = InteractVLM(tcfg, device="cpu")
    init_params(tm, torch.Generator().manual_seed(0))
    tm.load_state_dict(from_jax_params(tree), strict=False)
    sd = tm.state_dict()
    tb = make_synthetic_batch(tcfg, B=B, L=L, mask_size=MASK, device="cpu")
    mesh = create_mesh(n_data=1, n_model=1, devices=jax.devices()[:1])
    tx, _ = jax_make_opt(lr=LR, warmup_steps=0, total_steps=50, mask=jax_mask)
    micro2 = jax.tree.map(lambda a: jnp.stack([a, a]), jb)
    with mesh:
        _, shardings = create_sharded_state(jm, tx, jb, mesh)
        # one compiled step for both tests: two equal micro-batches average
        # to the one batch's gradient and metrics
        step = make_train_step(jm, tx, mesh, shardings, jb, donate=False,
                               accum_steps=2)
    return dict(jcfg=jcfg, tcfg=tcfg, jm=jm, tree=tree, jb=jb, sd=sd, tb=tb,
                grads=_start_grads(tcfg, sd, [tb]), mesh=mesh, tx=tx,
                step=step, twice=micro2)


def _start_grads(tcfg, sd, micro):
    """The gradient at the start (averaged over ``micro``), which
    tests/test_torch_train.py holds against the JAX package's: where it
    sits at noise, so does the sign of Adam's first update."""
    tm = InteractVLM(tcfg, device="cpu")
    tm.load_state_dict(sd, strict=False)
    apply_trainable_mask(tm)
    for mb in micro:
        (tm(mb)["loss"] / len(micro)).backward()
    return {n: p.grad.detach().clone() for n, p in tm.named_parameters()
            if p.grad is not None}


def _jax_steps(setup, batches):
    """The JAX step (``accum_steps=2``, on a 1 x 1 mesh) from the setup's
    weights over stacked micro-batch pairs: each step's metrics and the
    trainables (port names) after it."""
    from interactvlm_tpu.train.train_step import TrainState

    tree, tx = setup["tree"], setup["tx"]
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=jax.tree.map(jnp.asarray, tree),
                       opt_state=tx.init(tree))
    out = []
    with setup["mesh"]:
        for b in batches:
            state, m = setup["step"](state, b)
            out.append((jax.tree.map(float, m),
                        from_jax_params(_np(state.params))))
    return out


def _check_params(got, want, grads, names):
    floor = NOISE * max(np.abs(g.numpy()).max() for g in grads.values())
    moved = 0
    for n in names:
        if n not in grads:  # a trainable the loss does not reach
            np.testing.assert_array_equal(got[n].numpy(), want[n].numpy())
            continue
        g = np.abs(grads[n].numpy())
        sure = g > max(1e-3 * g.max(), floor)
        np.testing.assert_allclose(got[n].numpy()[sure],
                                   want[n].numpy()[sure], rtol=0,
                                   atol=2e-3 * LR, err_msg=n)
        moved += int(sure.any())
    assert moved > 20


def test_sharded_step_on_2x2_matches_jax_and_the_nan_guard(setup):
    """``make_eval_step`` on 2 x 2 against one process's forward; three
    ``TrainStep`` steps on 2 x 2 against the JAX step: each
    step's loss terms and gradient norm, the trainables after each step;
    Adam's moments of the ZeRO-sharded leaves are half of the one-card
    bytes on each rank; then a batch whose first row (data rank 0's) holds
    NaN targets: the guard skips the update on every rank."""
    want = _jax_steps(setup, [setup["twice"]] * 3)
    bad = dict(setup["tb"])
    bad["gt_hcontact"] = bad["gt_hcontact"].clone()
    bad["gt_hcontact"][0] = float("nan")
    res = spawn(R.train, 4, n_model=2, args=(
        setup["tcfg"], setup["sd"], [setup["tb"]] * 3, LR, bad))
    one = InteractVLM(setup["tcfg"], device="cpu")
    one.load_state_dict(setup["sd"])
    with torch.no_grad():
        fwd = one(setup["tb"])
    for r in res:
        # make_eval_step: the global batch's loss, every row's masks
        np.testing.assert_allclose(r["eval"]["loss"], fwd["loss"].item(),
                                   rtol=1e-5)
        np.testing.assert_allclose(r["eval"]["pred_masks"].numpy(),
                                   fwd["pred_masks"].numpy(), rtol=1e-4,
                                   atol=1e-4)
        for i, (jm_, jp) in enumerate(want):
            for k in KEYS:
                np.testing.assert_allclose(r["metrics"][i][k], jm_[k],
                                           rtol=1e-4, err_msg=f"{i} {k}")
            _check_params(r["params"][i], jp, setup["grads"],
                          r["params"][i].keys())
        assert r["nan"] == dict(skipped=1.0, step=3, params_kept=True,
                                moments_kept=True)
    # ZeRO split the tables and the large adapters over data; LLaMA's
    # vocabulary and heads over model
    zero, tp = res[0]["zero_dims"], res[0]["tp_dims"]
    assert "llava.lm.model.embed_tokens.weight" in zero
    assert tp["llava.lm.lm_head.weight"] == 0
    assert tp["llava.lm.model.layers.0.self_attn.q_proj.lora_B.weight"] == 0
    assert R.ranks_agree([{"m": [m["loss"] for m in r["metrics"]]}
                          for r in res], "m")
    assert res[0]["moment_bytes"] < _one_card_moment_bytes(setup)


def _one_card_moment_bytes(setup):
    tm = InteractVLM(setup["tcfg"], device="cpu")
    tm.load_state_dict(setup["sd"])
    opt, sched = make_optimizer(tm, lr=LR, warmup_steps=0, total_steps=50)
    TrainStep(tm, opt, sched)(setup["tb"])
    return sum(v.numel() * v.element_size() for st in opt.state.values()
               for k, v in st.items() if k != "step")


def test_sharded_step_with_accumulation_matches_jax(setup):
    """Two steps of two micro-batches each on 2 x 2 against the JAX step
    with ``accum_steps=2``."""
    tcfg, jcfg = setup["tcfg"], setup["jcfg"]
    micro = [make_synthetic_batch(tcfg, B=B, L=L, mask_size=MASK, seed=s,
                                  device="cpu") for s in (0, 1)]
    jmicro = [jax_batch(jcfg, B=B, L=L, mask_size=MASK, seed=s)
              for s in (0, 1)]
    stacked = jax.tree.map(lambda a, b: jnp.stack([a, b]), *jmicro)
    want = _jax_steps(setup, [stacked] * 2)
    res = spawn(R.train, 4, n_model=2, args=(
        tcfg, setup["sd"], [micro] * 2, LR))
    grads = _start_grads(tcfg, setup["sd"], micro)
    for i, (jm_, jp) in enumerate(want):
        for k in KEYS:
            np.testing.assert_allclose(res[0]["metrics"][i][k], jm_[k],
                                       rtol=1e-4, err_msg=f"{i} {k}")
        _check_params(res[0]["params"][i], jp, grads,
                      res[0]["params"][i].keys())


def test_checkpoints_round_trip_between_2x2_and_one_card(setup):
    """A 2 x 2 checkpoint (the one-card format, gathered) resumes on one
    card, and a one-card checkpoint resumes on 2 x 2: each run's second
    step, and the state after it, agree with the one-card run's as the
    steps themselves do (``_check_params``); the frozen weights are equal."""
    tcfg, sd, tb = setup["tcfg"], setup["sd"], setup["tb"]
    grads = setup["grads"]
    tm = InteractVLM(tcfg, device="cpu")
    tm.load_state_dict(sd)
    opt, sched = make_optimizer(tm, lr=LR, warmup_steps=0, total_steps=50)
    step = TrainStep(tm, opt, sched)
    loss1 = float(step(tb)["loss"])
    one_state = copy.deepcopy({"model": tm.state_dict(),
                               "optimizer": opt.state_dict(),
                               "scheduler": sched.state_dict(),
                               "step": step.step})
    loss2 = float(step(tb)["loss"])
    after = {n: p.detach().clone() for n, p in tm.named_parameters()}
    trained = [n for n, p in tm.named_parameters() if p.requires_grad]

    # 2 x 2 from the weights, one step; its checkpoint resumes on one card
    first = spawn(R.checkpoint, 4, n_model=2, args=(tcfg, sd, tb, LR))[0]
    np.testing.assert_allclose(first["loss"], loss1, rtol=1e-5)
    st = first["state"]
    assert set(st["model"]) == set(one_state["model"])
    _check_params(st["model"], one_state["model"], grads, trained)
    for k, v in one_state["model"].items():
        if k not in trained:
            assert torch.equal(st["model"][k], v), k
    tm2 = InteractVLM(tcfg, device="cpu")
    opt2, sched2 = make_optimizer(tm2, lr=LR, warmup_steps=0, total_steps=50)
    tm2.load_state_dict(st["model"])
    opt2.load_state_dict(st["optimizer"])
    sched2.load_state_dict(st["scheduler"])
    step2 = TrainStep(tm2, opt2, sched2)
    step2.step = st["step"]
    np.testing.assert_allclose(float(step2(tb)["loss"]), loss2, rtol=1e-4)
    assert step2.step == 2 and sched2.last_epoch == 2

    # the one-card checkpoint resumes on 2 x 2
    second = spawn(R.checkpoint, 4, n_model=2,
                   args=(tcfg, sd, tb, LR, one_state))[0]
    np.testing.assert_allclose(second["loss"], loss2, rtol=1e-5)
    st2 = second["state"]
    assert st2["step"] == 2 and st2["scheduler"]["last_epoch"] == 2
    _check_params(st2["model"], after, grads, trained)
    moments = st2["optimizer"]["state"]
    ref = opt.state_dict()["state"]
    assert sorted(moments) == sorted(ref)
    for i, r in ref.items():
        assert moments[i]["exp_avg"].shape == r["exp_avg"].shape
        assert float(moments[i]["step"]) == 2.0
        np.testing.assert_allclose(moments[i]["exp_avg_sq"].numpy(),
                                   r["exp_avg_sq"].numpy(), rtol=1e-3,
                                   atol=1e-12)


def _val_batches(cfg):
    out = []
    for i, b in enumerate((4, 3)):  # a short last batch pads a rank
        batch = make_synthetic_batch(cfg, B=b, tasks=(2,), mask_size=MASK,
                                     seed=i, device="cpu")
        meta = {"image_paths": [f"v{i}_{j}" for j in range(b)],
                "sampled_classes_list": [["chair"]] * b}
        out.append((batch, meta))
    return out


@pytest.mark.parametrize("mode", ["generate", "forward"])
def test_distributed_validate_gives_the_one_rank_report(mode):
    tcfg = interactvlm_tiny()
    model = InteractVLM(tcfg, device="cpu")
    init_params(model, torch.Generator().manual_seed(1))
    with torch.no_grad():  # [SEG] answers from some rows
        model.llava.lm.lm_head.weight[tcfg.seg_token_idx] += 0.5
    sd = model.state_dict()
    batches = _val_batches(tcfg)
    ex = batches[0][0]
    maps = {"p2v": ex["human_p2v"], "bary": ex["human_bary"],
            "num_vertices": tcfg.num_human_vertices}
    want, saved = validate(iter(batches), model, "hcontact", MASK,
                           inference_type=mode, human_maps=maps,
                           max_new_tokens=6)
    res = spawn(R.validate, 2, args=(tcfg, sd, batches, mode, maps))
    for got, f1s in res:
        assert got == want
        assert f1s == saved["f1"] and len(f1s) == 7
    if mode == "generate":
        assert 0 < want["seg_rate"] < 1


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_damon"))
    make_damon_tree(root, generate=port_damon_tree, device="cpu")
    return root


@pytest.mark.parametrize("workers", [1, 3])
def test_data_ranks_collate_the_one_process_rows(port_tree, workers):
    """The real loader on two data ranks: each rank's batches are its half
    of the one-process loader's (one worker) rows, templates and parts
    dropout included, whatever the number of workers on the ranks."""
    def argv(w):
        return ["--tokenizer", "whitespace", "--model_scale", "tiny",
                "--dataset_dir", port_tree, "--dataset",
                "hcontact||hcontact_scene", "--sample_rates", "2,1",
                "--image_size", str(TREE_SIZE), "--clip_size", "28",
                "--num_human_vertices", "178", "--model_max_length", "384",
                "--batch_size", "4", "--data_workers", str(w),
                "--prefetch_depth", "1"]

    one = R.loader(Mesh(), argv(1), 2)
    ranks = spawn(R.loader, 2, args=(argv(workers), 2))
    for r, got in enumerate(ranks):
        for b, want in zip(got, one):
            want = take_rows(want, [2 * r, 2 * r + 1], 4)
            assert set(b) == set(want)
            for k in want:
                np.testing.assert_array_equal(b[k], want[k], err_msg=k)


def test_train_cli_on_2x2_and_eval_cli_distributed(tmp_path):
    """``--n_model_shards 2`` on four ranks: the synthetic run's losses
    equal the one-process CLI's, rank 0 alone writes the run directory;
    then ``--distributed`` on two ranks gives the one-process report of
    that run."""
    def argv(base):
        return ["--synthetic", "--epochs", "1", "--steps_per_epoch", "2",
                "--batch_size", "4", "--device", "cpu", "--lr", "1e-3",
                "--warmup_steps", "0", "--no_eval", "--no_tensorboard",
                "--log_base_dir", str(base), "--exp_name", "s"]
    one = train_main(argv(tmp_path / "one"))
    res = spawn(R.cli, 4, args=(argv(tmp_path / "tp") + [
        "--n_model_shards", "2"], None))
    for r in res:
        np.testing.assert_allclose(r["losses"], [h["loss"] for h in
                                                 one.history], rtol=1e-5)
        assert r["step"] == 2 and r["n_model"] == 2
    run = str(tmp_path / "tp" / "s")
    ev = ["--run_dir", run, "--synthetic", "--max_batches", "2",
          "--batch_size", "3", "--max_new_tokens", "4", "--device", "cpu"]
    want = eval_main(ev)
    got = spawn(R.cli, 2, args=(None, ev + ["--distributed"]))
    for r in got:
        assert r["report"] == want


def test_dryrun_multichip_on_four_cpu_ranks():
    res = graft_entry_torch.dryrun_multichip(4, device="cpu")
    assert len(res) == 4 and len({r["loss"] for r in res}) == 1
    assert len({tuple(r["tokens"]) for r in res}) == 1
