"""The training step, on one card or on an (n_data, n_model) mesh of ranks.

Port of ``interactvlm_tpu/train/train_step.py:make_train_step``: forward,
backward, the global gradient norm over the trainables, optax's global-norm
clip, AdamW and the schedule, with gradient accumulation as the mean of the
micro-batch gradients and the NaN guard of the reference
(``train.py:547-551``): a non-finite loss or gradient norm skips the update,
leaving the parameters, Adam's moments, the schedule and the step counter as
they were. The JAX step routes frozen parameters (the QLoRA int8 base among
them) around autodiff; here they have ``requires_grad`` off
(``train/optimizer.py:apply_trainable_mask``), so none of them takes a
``.grad``.

On a mesh (``parallel/mesh.py``) the step follows the JAX package's ZeRO
and batch sharding rules (``opt_state_specs``, ``batch_specs``);
``make_eval_step`` is the forward under that layout. On ``Mesh(1, 1)``
every collective is the identity and no process group is needed.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.nn as nn

from interactvlm_tpu_torch.parallel.mesh import Mesh
from interactvlm_tpu_torch.train.optimizer import (
    clip_by_global_norm_,
    global_norm,
)

Batch = Dict[str, torch.Tensor]
GRAD_CLIP = 1.0  # the preset's global-norm clip


# --- the step on an (n_data, n_model) mesh ---------------------------------
# Port of the sharding half of ``interactvlm_tpu/train/train_step.py``:
# ``zero_shard_leaf``, ``opt_state_shardings``, ``batch_shardings`` and the
# pjit step, whose partitioning changes no math. Specs here are tuples of
# mesh axes (None: whole), one a dim.

ZERO_MIN_SIZE = 2 ** 14


def zero_shard_spec(shape: Sequence[int], n_data: int,
                    min_size: int = ZERO_MIN_SIZE):
    """The JAX package's ``zero_shard_leaf``: a leaf of at least
    ``min_size`` elements is split over ``data`` on its first axis that
    ``n_data`` divides; the rest stay whole."""
    spec = [None] * len(shape)
    if math.prod(shape) >= min_size:
        for i, s in enumerate(shape):
            if s > 0 and s % n_data == 0:
                spec[i] = "data"
                break
    return tuple(spec)


def opt_state_specs(params: Dict[str, Any], n_data: int,
                    min_size: int = ZERO_MIN_SIZE):
    """{name: spec} of Adam's moments (the JAX package's
    ``opt_state_shardings``) for ``params``, name -> a tensor (or anything
    with ``shape``) of the UNSHARDED parameter in the torch layout; the
    specs are in the torch layout. A moment keeps its parameter's tensor-
    parallel spec and is also split over ``data`` on the first free axis
    that ``n_data`` divides (in the JAX layout, as there), where it has at
    least ``min_size`` elements.

    The JAX function finds a moment's parameter spec by the leaf's shape and
    dtype; here it is the parameter's own, which is the same wherever no
    other parameter of that shape and dtype has another spec (the trainer's
    trainables; not the tiny preset's text projection, whose (64, 64) f32
    kernel shares its shape with the tiny LLaMA's projections)."""
    from interactvlm_tpu_torch.parallel.mesh import (
        jax_shape,
        jax_spec,
        to_torch_spec,
    )

    out = {}
    for name, t in params.items():
        shape = tuple(t.shape)
        js = jax_shape(name, shape)
        spec = list(jax_spec(name, len(js)))
        if math.prod(js) >= min_size:
            for i, s in enumerate(js):
                if spec[i] is None and s > 0 and s % n_data == 0:
                    spec[i] = "data"
                    break
        out[name] = to_torch_spec(name, spec, len(shape))
    return out


def batch_specs(batch: Dict[str, Any], n_data: int):
    """The JAX package's ``batch_shardings``: a leaf whose leading size
    ``n_data`` divides is split over ``data`` on it; the others (the shared
    human lift maps among them) stay whole on every rank."""
    def one(leaf):
        shape = getattr(leaf, "shape", ())
        if len(shape) > 0 and shape[0] % n_data == 0 and shape[0] >= n_data:
            return ("data",)
        return ()

    return {k: one(v) for k, v in batch.items()}


# the row axis of the leaves that keep their rows off the leading axis: the
# per-sample object maps, corner-major (3, B, V, H, W); and the leaves every
# row shares, the human lift maps (3, V, H, W), whatever the row count
ROW_DIMS = {"obj_p2v": 1, "obj_bary": 1}
SHARED = frozenset({"human_p2v", "human_bary"})


def take_rows(batch: Dict[str, Any], index, rows: int):
    """The batch at rows ``index`` (a 1-D index tensor or list) of its
    ``rows``: every tensor that holds the rows (on its leading axis, or on
    ``ROW_DIMS``'s) indexed there, the rest (shared lift maps; with
    ``image_index`` the compact image leaves, whose rows keep their
    indices into them) whole."""
    whole = set(SHARED)
    if "image_index" in batch:
        whole |= {"images_clip", "sam_images"}
    out = {}
    for k, v in batch.items():
        d = ROW_DIMS.get(k, 0)
        if (k not in whole and hasattr(v, "shape") and len(v.shape) > d
                and v.shape[d] == rows):
            idx = torch.as_tensor(index, dtype=torch.long)
            if torch.is_tensor(v):
                out[k] = v.index_select(d, idx.to(v.device))
            else:
                out[k] = v.take(idx.numpy(), axis=d)
        else:
            out[k] = v
    return out


def shard_batch(batch: Dict[str, Any], mesh):
    """This data rank's part of a global batch: (local batch, split). The
    rows are split where their count divides over the data ranks, as
    ``batch_specs`` splits the leading axis of ``input_ids`` (each rank
    takes its block of rows in every leaf that holds them,
    ``take_rows``); else every rank takes the whole batch and ``split`` is
    False."""
    n, i = mesh.n_data, mesh.data_index
    rows = batch["input_ids"].shape[0]
    if n == 1 or rows % n:
        return batch, False
    per = rows // n
    return take_rows(batch, list(range(i * per, (i + 1) * per)), rows), True


class TrainStep:
    """One optimizer step; on an (n_data, n_model) mesh the JAX package's
    sharded ``make_train_step``, which computes what the unsharded step
    computes (up to summation order):

    - the model is built with the mesh (LLaMA tensor-parallel over
      ``model``) and each data rank takes its rows of the global batch;
      the losses are the global batch's (``collectives.batch_group``: every
      sum over rows runs over the data ranks), so each rank's backward
      gives its rows' share of the global gradient, and the shares are
      summed over ``data`` by all-reduce;
    - the global gradient norm sums the squares of the tensor-parallel
      leaves over ``model`` and counts each leaf that is whole on the model
      ranks once; the clip, then AdamW;
    - Adam's moments are ZeRO-sharded over ``data`` as ``opt_state_specs``
      says: each data rank updates its block of each such parameter, then
      the blocks are all-gathered;
    - the NaN guard (a non-finite loss or norm skips the update) decides
      once for every rank;
    - a sequence of micro-batches averages their gradients.

    ``TrainStep(model, mesh=...)`` builds its optimizer and schedule with
    ``make_optimizer`` over this rank's ZeRO pieces (views of the
    parameters). ``TrainStep(model, optimizer, scheduler)`` takes them
    given, over whole parameters; a given optimizer cannot be ZeRO-sharded
    (raises on a mesh with more than one data rank).

    ``step(batch)`` runs one step and returns the scalar metrics (0-d
    tensors): every 0-d entry of the model's results dict (averaged over
    micro-batches), ``grad_norm`` before the clip, and
    ``skipped_nonfinite`` (1 where the guard skipped the update). ``batch``
    is a global batch or a list of micro-batches, of which this rank takes
    its rows (``shard_batch``); ``local=True`` takes batches of this rank's
    rows already (a loader that collates each rank's share). ``mark``, when
    given, is called with ``"forward"``, ``"backward"`` and ``"optimizer"``
    as each phase ends (a timer's hook). ``self.step`` counts the updates
    applied. ``state_dict`` gives, and ``load_state_dict`` takes, the
    one-card checkpoint format."""

    def __init__(self, model: nn.Module, optimizer=None, scheduler=None,
                 mesh: Optional[Mesh] = None, lr: float = 3e-4,
                 warmup_steps: int = 100, total_steps: int = 15000):
        from interactvlm_tpu_torch.parallel.mesh import sharded_dim
        from interactvlm_tpu_torch.train.optimizer import (
            apply_trainable_mask,
            make_optimizer,
        )

        mesh = mesh or Mesh()
        self.model, self.mesh = model, mesh
        if optimizer is None:
            apply_trainable_mask(model)
            self.params = [p for p in model.parameters() if p.requires_grad]
        elif mesh.n_data > 1:
            raise ValueError("TrainStep: Adam's moments shard over the data "
                             "ranks only in the optimizer TrainStep builds; "
                             "pass no optimizer on this mesh")
        else:
            self.params = [p for g in optimizer.param_groups
                           for p in g["params"]]
        names = {id(p): n for n, p in model.named_parameters()}
        self.names = [names[id(p)] for p in self.params]
        self.tp_dims = {}
        full = {}
        for n, p in zip(self.names, self.params):
            shape = list(p.shape)
            d = sharded_dim(n, p.dim()) if mesh.n_model > 1 else None
            if d is not None:
                self.tp_dims[n] = d
                shape[d] *= mesh.n_model
            full[n] = torch.empty(shape, device="meta")
        self.zero_dims = {}
        if mesh.n_data > 1:
            self.zero_dims = {n: s.index("data") for n, s in
                              opt_state_specs(full, mesh.n_data).items()
                              if "data" in s}
        # the tensors the optimizer updates: a ZeRO-sharded parameter's
        # block (a view of it), else the parameter itself
        self.pieces = [self._piece(n, p.data) if n in self.zero_dims else p
                       for n, p in zip(self.names, self.params)]
        if optimizer is None:
            optimizer, scheduler = make_optimizer(
                model, lr=lr, warmup_steps=warmup_steps,
                total_steps=total_steps, params=self.pieces)
        self.optimizer, self.scheduler = optimizer, scheduler
        self.step = 0

    def _piece(self, name, t):
        """This data rank's block of ``t`` (a view), along the moment's
        ``data`` dim."""
        from interactvlm_tpu_torch.parallel.mesh import take_block

        d = self.zero_dims.get(name)
        if d is None:
            return t
        return take_block(t, d, self.mesh.n_data, self.mesh.data_index)

    def moment_bytes(self) -> int:
        """Bytes of Adam's moments this rank holds."""
        return sum(v.numel() * v.element_size()
                   for st in self.optimizer.state.values()
                   for k, v in st.items() if k in ("exp_avg", "exp_avg_sq"))

    def __call__(self, batch: Union[Batch, Sequence[Batch]],
                 mark: Optional[Callable[[str], None]] = None,
                 local: bool = False,
                 on_grads: Optional[Callable[..., None]] = None):
        """One step; ``on_grads(names, grads, norm)``, when given, sees this
        rank's gradients (summed over ``data``, averaged over micro-batches)
        and the global norm before the clip."""
        from interactvlm_tpu_torch.parallel import collectives as C
        from interactvlm_tpu_torch.utils.profiling import annotate

        mesh = self.mesh
        micro = [batch] if isinstance(batch, dict) else list(batch)
        split = True
        if not local:
            cut = [shard_batch(mb, mesh) for mb in micro]
            micro = [mb for mb, _ in cut]
            split = all(s for _, s in cut)
        split = split and mesh.n_data > 1
        mark = mark or (lambda phase: None)
        for p in self.params:
            p.grad = None
        sums: Dict[str, torch.Tensor] = {}
        with C.batch_group(mesh.data_group if split else None):
            for mb in micro:
                with annotate("forward"):
                    out = self.model(mb)
                mark("forward")
                with annotate("backward"):
                    out["loss"].backward()
                mark("backward")
                for k, v in out.items():
                    if v.dim() == 0:
                        sums[k] = sums.get(k, 0.0) + v.detach().float()
                del out
        n = len(micro)
        metrics = {k: v / n for k, v in sums.items()}
        with torch.no_grad(), annotate("optimizer"):
            grads = []
            for p in self.params:
                if p.grad is None:  # a trainable the loss does not reach
                    p.grad = torch.zeros_like(p)
                elif n > 1:
                    p.grad.div_(n)
                grads.append(p.grad)
            if split:
                with annotate("grad_all_reduce"):
                    C.all_reduce_coalesced_(grads, mesh.data_group)
            norm = self._global_norm(grads)
            metrics["grad_norm"] = norm
            if on_grads is not None:
                on_grads(self.names, grads, norm)
            ok = torch.isfinite(metrics["loss"]) & torch.isfinite(norm)
            if mesh.n_data * mesh.n_model > 1:
                # one decision for every rank
                flag = ok.to(torch.int32).reshape(1).to(norm.device)
                dist.all_reduce(flag, op=dist.ReduceOp.MIN)
                ok = flag[0] > 0
            ok = bool(ok)
            if ok:
                clip_by_global_norm_(grads, norm, GRAD_CLIP)
                for name, piece, g in zip(self.names, self.pieces, grads):
                    if name in self.zero_dims:
                        piece.grad = self._piece(name, g)
                self.optimizer.step()
                self.scheduler.step()
                self.step += 1
                self._gather_pieces()
            for piece in self.pieces:
                piece.grad = None
        metrics["skipped_nonfinite"] = torch.tensor(0.0 if ok else 1.0)
        for p in self.params:
            p.grad = None
        mark("optimizer")
        return metrics

    def _global_norm(self, grads):
        from interactvlm_tpu_torch.parallel.collectives import all_reduce_sum

        if not self.tp_dims:
            return global_norm(grads)
        split = [g for n, g in zip(self.names, grads) if n in self.tp_dims]
        whole = [g for n, g in zip(self.names, grads) if n not in self.tp_dims]
        sq = sum(g.float().square().sum() for g in split)
        sq = all_reduce_sum(sq, self.mesh.model_group)
        return torch.sqrt(sq + sum(g.float().square().sum() for g in whole))

    def _gather_pieces(self):
        from interactvlm_tpu_torch.parallel.collectives import all_gather_batch
        from interactvlm_tpu_torch.utils.profiling import annotate

        if not self.zero_dims:
            return
        with annotate("param_all_gather"):
            for name, p, piece in zip(self.names, self.params, self.pieces):
                d = self.zero_dims.get(name)
                if d is not None:
                    p.data.copy_(all_gather_batch(piece.contiguous(),
                                                  self.mesh.data_group, d))

    # --- the one-card checkpoint format ---------------------------------
    def _full(self, name, t, axes=("data", "model")):
        """``t`` (this rank's block of a parameter-shaped tensor) gathered
        whole over ``axes``."""
        from interactvlm_tpu_torch.parallel.collectives import all_gather_batch

        mesh = self.mesh
        if "data" in axes and name in self.zero_dims:
            t = all_gather_batch(t.contiguous(), mesh.data_group,
                                 self.zero_dims[name])
        if "model" in axes and name in self.tp_dims:
            t = all_gather_batch(t.contiguous(), mesh.model_group,
                                 self.tp_dims[name])
        return t

    def state_dict(self):
        """The checkpoint, {"model", "optimizer", "scheduler", "step"}, in
        the one-card format on every layout: the whole model's state dict
        (its tensor-parallel leaves gathered, ``gather_params``) and the
        optimizer's state over the whole trainables, in their order. On a
        mesh every rank must call it (collectives); every rank gets the
        result."""
        sd = self.optimizer.state_dict()
        state = {}
        for i, name in enumerate(self.names):
            st = sd["state"].get(i)
            if st is None:
                continue
            state[i] = {k: (self._full(name, v) if k != "step" else v)
                        for k, v in st.items()}
        return {"model": gather_params(self.model, self.mesh),
                "optimizer": {"state": state,
                              "param_groups": sd["param_groups"]},
                "scheduler": self.scheduler.state_dict(),
                "step": self.step}

    def load_state_dict(self, state):
        """Restore a one-card checkpoint onto this layout: the model's
        blocks cut by ``parallel/mesh.py:shard_params``, AdamW's moments
        cut the same way and then over ``data``."""
        from interactvlm_tpu_torch.parallel.mesh import shard_tensor

        mesh = self.mesh
        # copied into the parameters in place: the pieces stay their views
        self.model.load_state_dict(
            shard_params_of(self.model, state["model"], mesh))
        opt = state["optimizer"]
        local = {}
        for i, name in enumerate(self.names):
            st = opt["state"].get(i)
            if st is None:
                continue
            dev = self.params[i].device
            local[i] = {}
            for k, v in st.items():
                if k != "step":
                    v = shard_tensor(name, v, mesh.n_model, mesh.model_index)
                    v = self._piece(name, v).to(dev)
                # own copies: AdamW's foreach step adds one to each "step"
                # in place, and the given tensors may be shared
                local[i][k] = v.clone()
        self.optimizer.load_state_dict({"state": local,
                                        "param_groups": opt["param_groups"]})
        self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])


def shard_params_of(model: nn.Module, full_sd, mesh):
    """``full_sd`` cut to ``model``'s layout, in ``model.state_dict()``'s
    key order (keys the model lacks, or ``full_sd`` does, left out)."""
    from interactvlm_tpu_torch.parallel.mesh import shard_params

    cut = shard_params(full_sd, mesh)
    return {k: cut[k] for k in model.state_dict() if k in cut}


def gather_params(model: nn.Module, mesh) -> Dict[str, torch.Tensor]:
    """The whole (one-card) state dict of a model built on ``mesh``: each
    tensor-parallel leaf all-gathered over ``model`` (a row-parallel packed
    int4 weight unpacked, gathered and packed again). Every rank calls it;
    every rank gets the whole dict."""
    from interactvlm_tpu_torch.ops.quant import pack_int4, unpack_int4
    from interactvlm_tpu_torch.parallel.collectives import all_gather_batch
    from interactvlm_tpu_torch.parallel.mesh import sharded_dim

    out = {}
    for k, v in model.state_dict().items():
        d = sharded_dim(k, v.dim()) if mesh.n_model > 1 else None
        if d is None:
            out[k] = v
        elif k.endswith("weight_q4") and d == 1:
            full = all_gather_batch(torch.cat(unpack_int4(v), dim=1),
                                    mesh.model_group, 1)
            out[k] = pack_int4(full)
        else:
            out[k] = all_gather_batch(v.contiguous(), mesh.model_group, d)
    return out


def make_eval_step(model: nn.Module, mesh):
    """The forward under the mesh's layout (the JAX package's
    ``make_eval_step``): ``fn(batch)`` takes a global batch, runs this data
    rank's rows without grad and returns the model's results with the
    losses over the global batch and ``pred_masks`` gathered over the data
    ranks in row order."""
    from interactvlm_tpu_torch.parallel import collectives as C

    @torch.no_grad()
    def fn(batch):
        local, split = shard_batch(batch, mesh)
        split = split and mesh.n_data > 1
        with C.batch_group(mesh.data_group if split else None):
            out = model(local)
        if split:
            out["pred_masks"] = C.all_gather_batch(
                out["pred_masks"].contiguous(), mesh.data_group, 0)
        return out

    return fn
