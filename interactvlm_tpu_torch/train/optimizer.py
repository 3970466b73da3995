"""Optimizer: AdamW, the warm-up/decay schedule and the freeze policy.

Port of ``interactvlm_tpu/train/optimizer.py``. The schedule is optax's
``join_schedules`` of two linear ramps (DeepSpeed ``WarmupDecayLR``): step 0
of a warm-up has lr 0. The freeze policy is the JAX package's path-substring
rules over the port's parameter names (``llava.lm.`` for ``/lm/``,
``lora_A`` / ``lora_B`` for ``lora_a`` / ``lora_b``). The global-norm clip
is optax's rule, which ``clip_by_global_norm`` applies: unchanged below
``max_norm``, else ``g / norm * max_norm`` (``clip_grad_norm_`` divides by
``norm + 1e-6`` instead).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence, Set

import torch
import torch.nn as nn

from interactvlm_tpu_torch.models.layers import Int4Linear, Int8Linear

TRAINABLE_SUBSTRINGS = (
    "mask_decoder", "text_hidden_fcs", "cam_pose_encoder",
    "attention_splitter", "fusion", "uncertainty", "lora_A", "lora_B",
    "embed_tokens", "lm_head", "mm_projector",
)
FROZEN_SUBSTRINGS = (
    "image_encoder", "prompt_encoder", "vision_tower", "mm_projector",
)


def warmup_decay_schedule(lr: float, warmup_steps: int,
                          total_steps: int) -> Callable[[int], float]:
    """Linear 0 -> lr over ``warmup_steps``, then lr -> 0 at
    ``total_steps`` (the JAX package's ``warmup_decay_schedule``)."""
    decay = max(total_steps - warmup_steps, 1)

    def linear(init: float, end: float, steps: int, count: int) -> float:
        # optax.linear_schedule's formula
        count = min(max(count, 0), steps)
        return (init - end) * (1 - count / steps) + end

    def sched(step: int) -> float:
        if step < warmup_steps:
            return linear(0.0, lr, warmup_steps, step)
        return linear(lr, 0.0, decay, step - warmup_steps)

    return sched


def trainable_mask(names: Iterable[str]) -> Dict[str, bool]:
    """Parameter name -> whether it trains. The SAM encoder and prompt
    encoder, CLIP and the mm_projector are frozen; the mask decoder, the
    text projection, the cam encoder, the LoRA factors, the token
    embeddings and the lm_head train; the rest of LLaMA is frozen,
    everything else trains."""

    def decide(p: str) -> bool:
        if any(s in p for s in FROZEN_SUBSTRINGS):
            return False
        if any(s in p for s in TRAINABLE_SUBSTRINGS):
            return True
        if "llava.lm." in p or p.startswith("lm."):
            return False
        return True

    return {n: decide(n) for n in names}


def quantized_params(model: nn.Module) -> Set[str]:
    """Names of the int8 and int4 layers' own parameters (the packed or
    int8 weight, its f32 scales and row factors, a bias): a frozen base,
    which no mask trains and no cast touches. A QLoRA projection's adapter
    is not among them."""
    names = set()
    for prefix, mod in model.named_modules():
        if isinstance(mod, (Int8Linear, Int4Linear)):
            names.update(f"{prefix}.{leaf}" if prefix else leaf
                         for leaf, _ in mod.named_parameters(recurse=False))
    return names


def apply_trainable_mask(model: nn.Module) -> Dict[str, bool]:
    """Set each parameter's ``requires_grad`` from ``trainable_mask``, so
    autograd never enters the frozen towers (the JAX step's stop-gradient
    closure) and never gives the int8 base a gradient (the JAX step's
    float0 cotangents); quantized parameters are frozen whatever their
    name. Returns the mask."""
    quantized = quantized_params(model)
    mask = {n: m and n not in quantized for n, m in trainable_mask(
        n for n, _ in model.named_parameters()).items()}
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    return mask


def cast_frozen_params(model: nn.Module, dtype: torch.dtype,
                       min_size: int = 2 ** 16) -> nn.Module:
    """Store frozen float parameters of at least ``min_size`` elements in
    the compute ``dtype`` and every trainable one in f32 (Adam's master
    copy), in place; int8 and int4 layers keep their parameters as they
    are. Layers cast their parameters to their compute dtype at every use,
    so a frozen bf16 weight computes as its f32 original did."""
    mask = trainable_mask(n for n, _ in model.named_parameters())
    quantized = quantized_params(model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in quantized:
                continue
            if mask[name]:
                p.data = p.data.float()
            elif p.is_floating_point() and p.numel() >= min_size:
                p.data = p.data.to(dtype)
    return model


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element, in f32 (optax's
    ``global_norm``)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def clip_by_global_norm_(grads: Sequence[torch.Tensor], norm: torch.Tensor,
                         max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` in place: unchanged when
    ``norm < max_norm``, else ``g / norm * max_norm``."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


def make_optimizer(model: nn.Module, lr: float = 3e-4,
                   warmup_steps: int = 100, total_steps: int = 15000,
                   params: Optional[Sequence[torch.Tensor]] = None):
    """AdamW with the reference hyperparameters (betas (0.9, 0.95), no
    weight decay, eps 1e-8) over the trainable parameters, and a
    ``LambdaLR`` that follows ``warmup_decay_schedule``. Applies the freeze
    policy first (``apply_trainable_mask``). ``params``, when given, are
    the tensors to update in the trainables' place, in their order (a
    ZeRO-sharded step's pieces, ``train_step.TrainStep``). Returns
    (optimizer, scheduler)."""
    mask = apply_trainable_mask(model)
    if params is None:
        params = [p for name, p in model.named_parameters() if mask[name]]
    sched = warmup_decay_schedule(lr, warmup_steps, total_steps)
    opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.95), eps=1e-8,
                            weight_decay=0.0)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: sched(step) / lr)
    return opt, scheduler
