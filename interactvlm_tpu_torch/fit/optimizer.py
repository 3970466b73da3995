"""Contact-guided object pose optimisation.

Port of ``interactvlm_tpu/fit/optimizer.py`` (the reference's
``optim/optimizer.py`` ObjPose_Opt and ``optim/fit.py:218-298``): Adam over
the object's 6-D rotation, translation and log scale, three parameter
groups with their own learning rates (the JAX package's
``optax.multi_transform`` of three Adams), the losses switched on by
step-dependent weights (``w * (step >= kick_in)``).

Losses (reference optimizer.py:80-175):
- silhouette IoU of the soft-rendered object mask against the detected
  mask;
- mask-centroid squared distance;
- contact loss: the probability-outer-product-weighted mean pairwise
  distance between object and human vertices.

The loop runs on the scene's device and reads nothing back to the host:
the best iterate and the histories stay tensors.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from interactvlm_tpu_torch.fit.renderer import render_silhouette
from interactvlm_tpu_torch.fit.utils import (
    _floor,
    apply_transformation,
    calculate_centroid,
)


class FitParams(NamedTuple):
    rot6d: torch.Tensor  # (6,)
    translation: torch.Tensor  # (3,)
    log_scale: torch.Tensor  # ()


class LossWeights(NamedTuple):
    """(weight, kick_in_step) pairs; kick_in < 0 disables the loss."""

    mask_w: float = 1.0
    mask_kick_in: int = 0
    centroid_w: float = 1e-4
    centroid_kick_in: int = 0
    contact_w: float = 1.0
    contact_kick_in: int = 50


def contact_loss(obj_verts, hum_verts, obj_probs, hum_probs):
    """Outer-product-weighted mean pairwise distance (reference
    optimizer.py:80-96)."""
    d2 = ((obj_verts ** 2).sum(-1, keepdim=True)
          - 2.0 * obj_verts @ hum_verts.T + (hum_verts ** 2).sum(-1)[None, :])
    dist = torch.sqrt(_floor(d2, 1e-12))
    w = obj_probs[:, None] * hum_probs[None, :]
    return (dist * w).sum() / _floor(w.sum(), 1e-8)


def mask_iou_loss(pred_mask, target_mask):
    """1 - soft IoU (reference optimizer.py:172-175, whose 'union' is
    sum(a + b))."""
    inter = (pred_mask * target_mask).sum()
    union = (pred_mask + target_mask).sum()
    return 1.0 - inter / _floor(union, 1e-8)


def kick_in_weights(weights: LossWeights, step: int) -> Dict[str, float]:
    """Each loss's weight at ``step``: its weight once ``step`` reaches its
    kick-in, 0 before, and 0 throughout for a negative kick-in."""
    return {name: w * (k >= 0) * (step >= k) for name, w, k in (
        ("mask_loss", weights.mask_w, weights.mask_kick_in),
        ("centroid_loss", weights.centroid_w, weights.centroid_kick_in),
        ("contact_loss", weights.contact_w, weights.contact_kick_in))}


def fit_losses(params: FitParams, step: int, scene: Dict,
               weights: LossWeights, image_size: int, sigma: float,
               window: int):
    """(total, {mask_loss, centroid_loss, contact_loss}) at ``params``."""
    obj_verts = apply_transformation(scene["obj_verts"], params.rot6d,
                                     params.translation,
                                     torch.exp(params.log_scale))
    sil = render_silhouette(obj_verts + scene["centroid_offset"],
                            scene["obj_faces"], scene["focal"],
                            scene["princpt"], image_size, window=window,
                            sigma=sigma)
    losses = {
        "mask_loss": mask_iou_loss(sil, scene["target_mask"]),
        "centroid_loss": ((calculate_centroid(sil)
                           - scene["target_centroid"]) ** 2).sum(),
        "contact_loss": contact_loss(obj_verts, scene["hum_verts"],
                                     scene["obj_contact_probs"],
                                     scene["hum_contact_probs"]),
    }
    total = sum(losses[k] * w for k, w in kick_in_weights(weights,
                                                          step).items())
    return total, losses


def make_fit_optimizer(params: FitParams, lr_rot: float = 5e-2,
                       lr_trans: float = 1e-2, lr_scale: float = 1e-2):
    """Adam with one parameter group a field (reference fit.py:218-226)."""
    return torch.optim.Adam([{"params": [params.rot6d], "lr": lr_rot},
                             {"params": [params.translation], "lr": lr_trans},
                             {"params": [params.log_scale], "lr": lr_scale}])


def run_fit(init_params: FitParams, scene: Dict, weights: LossWeights,
            num_steps: int = 250, image_size: int = 512, sigma: float = 1.0,
            window: int = 16, optimize_scale: bool = True,
            lr_rot: float = 5e-2, lr_trans: float = 1e-2,
            lr_scale: float = 1e-2):
    """The fitting loop. Returns (best_params, best_loss, loss_history
    (num_steps,), params_history (FitParams of (num_steps, ...))).

    As in the JAX package, step k's loss is taken at the parameters before
    its update, and when it is the best so far the parameters kept are
    those after it: the best iterate is one step late."""
    params = FitParams(*(p.detach().clone().float().requires_grad_()
                         for p in init_params))
    opt = make_fit_optimizer(params, lr_rot, lr_trans,
                             lr_scale if optimize_scale else 0.0)
    best_loss = torch.tensor(torch.inf, device=params.rot6d.device)
    best = [p.detach().clone() for p in params]
    loss_hist, params_hist = [], []
    for step in range(num_steps):
        opt.zero_grad(set_to_none=True)
        loss, _ = fit_losses(params, step, scene, weights, image_size, sigma,
                             window)
        loss.backward()
        opt.step()
        loss = loss.detach()
        better = loss < best_loss
        best_loss = torch.where(better, loss, best_loss)
        now = [p.detach().clone() for p in params]
        best = [torch.where(better, p, b) for p, b in zip(now, best)]
        loss_hist.append(loss)
        params_hist.append(now)
    return (FitParams(*best), best_loss, torch.stack(loss_hist),
            FitParams(*(torch.stack(h) for h in zip(*params_hist))))
