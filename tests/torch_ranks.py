"""Rank functions of the port's multi-rank CPU tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_distributed.py``).

``interactvlm_tpu_torch.parallel.launch.spawn`` runs each on every rank of
a gloo mesh; a spawned child imports this module by name, so it imports
torch and the port only (no JAX), and every function takes plain tensors
and configs and returns tensors, numbers and numpy arrays.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from interactvlm_tpu_torch.parallel import collectives as C


def collectives(mesh):
    """The six collectives over the data axis, one row of arange(8) as
    (4, 2) on each rank (``tests/test_train_step.py::
    test_collectives_on_mesh``'s layout)."""
    g, r = mesh.data_group, mesh.data_index
    full = torch.arange(8.0).reshape(4, 2)
    x = full[r:r + 1]
    # the bucketed in-place sum: 16-byte buckets hold the first two f32
    # leaves together, the (2, 2) one alone and the f64 one apart
    leaves = [torch.full((3,), r + 1.0), torch.full((1,), 2.0 * r),
              torch.full((2, 2), 10.0 * r),
              torch.full((5,), r + 0.5, dtype=torch.float64)]
    C.all_reduce_coalesced_(leaves, g, bucket_bytes=16)
    return dict(sum=C.all_reduce_sum(x, g), mean=C.all_reduce_mean(x, g),
                coalesced=leaves,
                gather=C.all_gather_batch(x, g),
                scatter=C.psum_scatter(full, g),
                ring=C.ppermute_ring(x, g, shift=1),
                host=C.host_gather(r, g),
                max=C.all_reduce_max(x, g))


def row_parallel(mesh, x, w8, s8, w4_full, s4, rf):
    """This model rank's slice of x (M, K) through the row-parallel int8
    and int4 products and the row-parallel quantization."""
    from interactvlm_tpu_torch.ops.quant import (
        int4_matmul_row_parallel,
        int8_matmul_row_parallel,
        row_parallel_quantize,
    )
    from interactvlm_tpu_torch.parallel.mesh import shard_tensor

    g, n, i = mesh.model_group, mesh.n_model, mesh.model_index
    k = x.shape[1] // n
    xs = x[:, i * k:(i + 1) * k]
    q8, sc8 = row_parallel_quantize(xs, g)
    rfs = rf[i * k:(i + 1) * k]
    q4, sc4 = row_parallel_quantize(xs, g, rfs)
    y8 = int8_matmul_row_parallel(xs, w8[:, i * k:(i + 1) * k], s8, g,
                                  torch.float32)
    w4 = shard_tensor("model.layers.0.mlp.down_proj.weight_q4", w4_full, n, i)
    y4 = int4_matmul_row_parallel(xs, w4, s4, rfs, g, torch.float32)
    return dict(q8=q8, s8=sc8, q4=q4, s4=sc4, y8=y8, y4=y4)


def decode(mesh, cfg, full_sd, ids, total, kv="dense"):
    """The tensor-parallel greedy decode of a LLaMA holding ``full_sd``."""
    from interactvlm_tpu_torch.models.llama import (
        LlamaForCausalLM,
        init_kv_cache,
    )
    from interactvlm_tpu_torch.ops.quant import init_kv_cache_int8
    from interactvlm_tpu_torch.train.train_step import shard_params_of
    from interactvlm_tpu_torch.utils.testing import greedy_decode_lm

    lm = LlamaForCausalLM(cfg, device="cpu", mesh=mesh)
    lm.load_state_dict(shard_params_of(lm, full_sd, mesh))
    B = ids.shape[0]
    init = init_kv_cache_int8 if kv == "int8" else init_kv_cache
    caches = init(cfg, B, total, "cpu", n_model=mesh.n_model)
    assert caches[0]["k"].shape[2] == cfg.num_kv_heads // mesh.n_model
    with torch.inference_mode():
        return greedy_decode_lm(lm, ids, caches, total)


def _model(mesh, cfg, full_sd):
    from interactvlm_tpu_torch.models.interactvlm import InteractVLM
    from interactvlm_tpu_torch.train.train_step import shard_params_of

    model = InteractVLM(cfg, device="cpu", mesh=mesh)
    missing, unexpected = model.load_state_dict(
        shard_params_of(model, full_sd, mesh), strict=False)
    assert not unexpected and all("mask_downscaling" in k for k in missing)
    return model


def train(mesh, cfg, full_sd, batches, lr, nan_batch=None):
    """``make_eval_step`` on the first batch, then ``TrainStep`` on
    each of ``batches`` (a batch or a list of micro-batches): each step's
    metrics and the whole trainables after it;
    then, with ``nan_batch``, one step on it (the NaN guard) and whether
    every parameter and moment stayed as it was."""
    from interactvlm_tpu_torch.train.train_step import (
        TrainStep,
        make_eval_step,
    )

    model = _model(mesh, cfg, full_sd)
    step = TrainStep(model, mesh=mesh, lr=lr, warmup_steps=0,
                     total_steps=50)
    out = {"metrics": [], "params": [], "moment_bytes": 0,
           "zero_dims": dict(step.zero_dims), "tp_dims": dict(step.tp_dims)}
    if isinstance(batches[0], dict):  # the forward under the layout
        ev = make_eval_step(model, mesh)(batches[0])
        out["eval"] = {"loss": float(ev["loss"]),
                       "pred_masks": ev["pred_masks"].float()}
    for b in batches:
        m = step(b)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        sd = step.state_dict()
        out["params"].append({k: sd["model"][k].clone()
                              for k in step.names})
    out["moment_bytes"] = step.moment_bytes()
    if nan_batch is not None:
        before = [p.detach().clone() for p in model.parameters()]
        moments = [v.clone() for st in step.optimizer.state.values()
                   for k, v in st.items() if k != "step"]
        m = step(nan_batch)
        out["nan"] = dict(
            skipped=float(m["skipped_nonfinite"]), step=step.step,
            params_kept=all(torch.equal(a, p) for a, p in
                            zip(before, model.parameters())),
            moments_kept=all(torch.equal(a, v) for a, v in zip(moments, [
                v for st in step.optimizer.state.values()
                for k, v in st.items() if k != "step"])))
    return out


def checkpoint(mesh, cfg, full_sd, batch, lr, state=None):
    """From ``state`` (a one-card checkpoint) or the weights: one step,
    then the one-card checkpoint, gathered."""
    from interactvlm_tpu_torch.train.train_step import TrainStep

    model = _model(mesh, cfg, full_sd)
    step = TrainStep(model, mesh=mesh, lr=lr, warmup_steps=0,
                     total_steps=50)
    if state is not None:
        step.load_state_dict(state)
    loss = float(step(batch)["loss"])
    return {"loss": loss, "state": step.state_dict()}


def validate(mesh, cfg, full_sd, batches, mode, human_maps):
    """``validate`` over ``batches`` ((batch, meta) pairs) on the mesh."""
    from interactvlm_tpu_torch.eval.evaluate import validate as run

    model = _model(mesh, cfg, full_sd)
    res, saved = run(iter(batches), model, "hcontact", 32,
                     inference_type=mode, human_maps=human_maps,
                     max_new_tokens=6, mesh=mesh)
    return res, saved["f1"]


def cli(mesh, train_argv, eval_argv):
    """The training CLI, then (on a data-only mesh) the eval CLI with
    ``--distributed``, on every rank."""
    from interactvlm_tpu_torch.eval.evaluate import main as eval_main
    from interactvlm_tpu_torch.train.train import main as train_main

    out = {}
    if train_argv:
        trainer = train_main(train_argv)
        out["losses"] = [h["loss"] for h in trainer.history]
        out["step"] = trainer.step.step
        out["n_model"] = trainer.model.llava.lm.n_model
    if eval_argv:
        out["report"] = eval_main(eval_argv)
    out["files"] = sorted(os.listdir(train_argv[train_argv.index(
        "--log_base_dir") + 1])) if train_argv else []
    return out


def loader(mesh, argv, n_batches):
    """The training CLI's real loader (``real_batch_iter``) on ``argv``'s
    tree at the tiny preset's sizes: its first ``n_batches`` batches on
    this rank (its rows of each global batch), as numpy arrays."""
    from argparse import Namespace

    from interactvlm_tpu_torch.train.train import parse_args, real_batch_iter
    from interactvlm_tpu_torch.utils.constants import add_new_tokens
    from interactvlm_tpu_torch.utils.testing import WhitespaceTokenizer

    args = parse_args(argv)
    cfg = Namespace(num_human_vertices=178, num_object_points=2048,
                    max_seg_tokens=1)
    tok = WhitespaceTokenizer(384)
    add_new_tokens(tok, "Gen")
    it = real_batch_iter(args, cfg, tok, "cpu", mesh)
    out = [{k: v.numpy() for k, v in next(it).items() if torch.is_tensor(v)}
           for _ in range(n_batches)]
    it.close()
    return out


def ranks_agree(results, key):
    """Whether every rank returned the same ``key``."""
    first = results[0][key]
    return all(np.array_equal(np.asarray(r[key]), np.asarray(first))
               for r in results[1:])

