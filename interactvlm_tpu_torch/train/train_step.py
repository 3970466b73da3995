"""The training step on one card.

Port of ``interactvlm_tpu/train/train_step.py:make_train_step`` without the
mesh: forward, backward, the global gradient norm over the trainables,
optax's global-norm clip, AdamW and the schedule, with gradient
accumulation as the mean of the micro-batch gradients and the NaN guard of
the reference (``train.py:547-551``): a non-finite loss or gradient norm
skips the update, leaving the parameters, Adam's moments, the schedule and
the step counter as they were. The JAX step routes frozen parameters (the
QLoRA int8 base among them) around autodiff; here they have
``requires_grad`` off (``train/optimizer.py:apply_trainable_mask``), so
none of them takes a ``.grad``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import torch
import torch.nn as nn

from interactvlm_tpu_torch.train.optimizer import (
    clip_by_global_norm_,
    global_norm,
)

Batch = Dict[str, torch.Tensor]
GRAD_CLIP = 1.0  # the preset's global-norm clip


class TrainStep:
    """``step(batch)`` runs one optimizer step and returns the scalar
    metrics (0-d tensors): every 0-d entry of the model's results dict
    (averaged over micro-batches), ``grad_norm`` before the clip, and
    ``skipped_nonfinite`` (1 where the guard skipped the update).

    ``batch`` is one batch dict, or a sequence of micro-batch dicts whose
    gradients are averaged. ``mark``, when given, is called with
    ``"forward"``, ``"backward"`` and ``"optimizer"`` as each phase ends
    (a timer's hook). ``self.step`` counts the updates applied."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 scheduler):
        self.model, self.optimizer, self.scheduler = model, optimizer, scheduler
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        self.step = 0

    def __call__(self, batch: Union[Batch, Sequence[Batch]],
                 mark: Optional[Callable[[str], None]] = None):
        micro = [batch] if isinstance(batch, dict) else list(batch)
        mark = mark or (lambda phase: None)
        for p in self.params:
            p.grad = None
        sums: Dict[str, torch.Tensor] = {}
        for mb in micro:
            out = self.model(mb)
            mark("forward")
            out["loss"].backward()
            mark("backward")
            for k, v in out.items():
                if v.dim() == 0:
                    sums[k] = sums.get(k, 0.0) + v.detach().float()
            del out
        n = len(micro)
        metrics = {k: v / n for k, v in sums.items()}
        grads = []
        with torch.no_grad():
            for p in self.params:
                if p.grad is None:  # a trainable the loss does not reach
                    p.grad = torch.zeros_like(p)
                elif n > 1:
                    p.grad.div_(n)
                grads.append(p.grad)
            norm = global_norm(grads)
            metrics["grad_norm"] = norm
            ok = bool(torch.isfinite(metrics["loss"])
                      & torch.isfinite(norm))
            if ok:
                clip_by_global_norm_(grads, norm, GRAD_CLIP)
                self.optimizer.step()
                self.scheduler.step()
                self.step += 1
        metrics["skipped_nonfinite"] = torch.tensor(0.0 if ok else 1.0)
        for p in self.params:
            p.grad = None
        mark("optimizer")
        return metrics
