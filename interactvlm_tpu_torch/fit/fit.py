"""Joint human-object fitting driver.

Port of ``interactvlm_tpu/fit/fit.py`` (the reference's ``optim/fit.py``):
given predicted human and object 3D contacts, an object mesh, the human
(SMPL-X) fit and a detected object mask, recover the object's 6-DoF pose
and scale against the human:

1. the translation from the object mask's centroid back-projected at the
   human's centroid depth (reference fit.py:119-135);
2. human contact vertices whose normal faces away from the camera by more
   than 90 degrees dropped (fit.py:141-167);
3. ICP on 6-D position (+) normal contact clouds (fit.py:176-193);
4. Adam with silhouette-IoU, centroid and contact losses on a kick-in
   schedule (fit.py:218-298).

``fit_human_object`` runs on the card unless the caller names the CPU.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from interactvlm_tpu_torch.fit.icp import icp
from interactvlm_tpu_torch.fit.optimizer import FitParams, LossWeights, run_fit
from interactvlm_tpu_torch.fit.renderer import render_phong
from interactvlm_tpu_torch.fit.utils import (
    _floor,
    _unit,
    apply_transformation,
    calculate_centroid,
    compute_vertex_normals,
    matrix_to_rot6d,
)
from interactvlm_tpu_torch.utils.device import resolve_device


def _tensor(x, dev):
    """A scene entry on ``dev``; floats in f32, as ``jnp.asarray`` makes
    them."""
    t = torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                        device=dev)
    return t.float() if t.is_floating_point() else t


def init_translation(mask, focal, princpt, depth: float):
    """Back-project the mask centroid at ``depth`` (reference
    fit.py:119-135; the camera flips x and y, see the renderer)."""
    cy, cx = calculate_centroid(mask.float())  # (row, col)
    x = -(cx - princpt[0]) * depth / focal[0]
    y = -(cy - princpt[1]) * depth / focal[1]
    return torch.stack([x, y, torch.tensor(depth, dtype=torch.float32,
                                           device=x.device)])


def filter_contacts_by_normal(verts, normals, probs, view_origin=None,
                              max_angle_deg: float = 90.0):
    """Zero the contact probability of vertices whose outward normal faces
    away from the camera beyond ``max_angle_deg`` (reference
    fit.py:141-167)."""
    origin = (torch.zeros(3, device=verts.device) if view_origin is None
              else view_origin)
    view_dir = _unit(verts - origin[None])
    cos = -(normals * view_dir).sum(-1)  # facing the camera: positive
    keep = cos >= float(np.cos(np.deg2rad(max_angle_deg)))
    return torch.where(keep, probs, 0.0)


def icp_init(obj_verts, obj_faces, hum_verts, hum_faces, obj_probs,
             hum_probs, threshold: float = 0.5, estimate_scale: bool = False,
             max_iterations: int = 100):
    """ICP on the contact point clouds: object points weighted by their
    contact, human points that are not contacts pushed 1e6 away so that
    they are never a neighbour."""
    obj_n = compute_vertex_normals(obj_verts, obj_faces)
    hum_n = compute_vertex_normals(hum_verts, hum_faces)
    ow = (obj_probs > threshold).float()
    hw = (hum_probs > threshold).float()
    hum_sel = torch.where(hw[:, None] > 0, hum_verts, 1e6)
    return icp(obj_verts, hum_sel, obj_normals=obj_n, hum_normals=hum_n,
               max_iterations=max_iterations, estimate_scale=estimate_scale,
               obj_weights=ow)


def prepare_scene(scene: Dict, device):
    """The scene as the fit takes it: tensors on ``device`` (floats in
    f32), the human contacts that face away from the camera dropped, the
    target mask's centroid added; and the start translation t0, the mask
    centroid back-projected at the human's mean depth."""
    scene = {k: _tensor(v, device) for k, v in scene.items()}
    off = scene["centroid_offset"]
    depth = float(scene["hum_verts"][:, 2].mean() + off[2])
    t0 = init_translation(scene["target_mask"], scene["focal"],
                          scene["princpt"], depth) - off
    scene["hum_contact_probs"] = filter_contacts_by_normal(
        scene["hum_verts"],
        compute_vertex_normals(scene["hum_verts"], scene["hum_faces"]),
        scene["hum_contact_probs"])
    scene["target_centroid"] = calculate_centroid(scene["target_mask"].float())
    return scene, t0


def fit_human_object(scene: Dict, weights: Optional[LossWeights] = None,
                     num_steps: int = 250, image_size: int = 512,
                     use_icp: bool = True, optimize_scale: bool = True,
                     contact_threshold: float = 0.5,
                     video_path: Optional[str] = None, video_every: int = 10,
                     device="cuda"):
    """End-to-end fit on ``device``. ``scene`` keys (numpy or tensors):
    obj_verts, obj_faces, hum_verts, hum_faces, obj_contact_probs,
    hum_contact_probs, target_mask (H, W), focal (2,), princpt (2,),
    centroid_offset (3,). Returns (best FitParams, diagnostics: best_loss,
    loss_history, init_params, params_history and, with ``video_path``,
    video_path)."""
    weights = weights or LossWeights()
    dev = resolve_device(device)
    scene, t0 = prepare_scene(scene, dev)

    # R0 in ICP's row-vector convention: verts' = s (v @ R0) + t0
    R0 = torch.eye(3, device=dev)
    s0 = torch.ones((), device=dev)
    if use_icp:
        sol = icp_init(scene["obj_verts"] + t0, scene["obj_faces"],
                       scene["hum_verts"], scene["hum_faces"],
                       scene["obj_contact_probs"], scene["hum_contact_probs"],
                       threshold=contact_threshold,
                       estimate_scale=optimize_scale)
        R_icp, T_icp, s_icp = sol.RTs
        # compose with the translation init:
        # verts' = s ((v + t0) @ R) + T = s (v @ R) + (s t0 @ R + T)
        R0, t0, s0 = R_icp, s_icp * (t0 @ R_icp) + T_icp, s_icp

    # apply_transformation computes v @ M^T with M = rot6d_to_matrix, so M
    # must be R0^T; matrix_to_rot6d takes M's first two rows
    init_params = FitParams(rot6d=matrix_to_rot6d(R0.T), translation=t0,
                            log_scale=torch.log(_floor(s0, 1e-4)))
    best, best_loss, loss_hist, params_hist = run_fit(
        init_params, scene, weights, num_steps=num_steps,
        image_size=image_size, optimize_scale=optimize_scale)
    diagnostics = {"best_loss": best_loss, "loss_history": loss_hist,
                   "init_params": init_params, "params_history": params_hist}
    if video_path is not None:
        save_fit_video(scene, params_hist, video_path, image_size=image_size,
                       every=video_every)
        diagnostics["video_path"] = video_path
    return best, diagnostics


def save_fit_video(scene: Dict, params_hist: FitParams, path: str,
                   image_size: int = 512, every: int = 10,
                   duration_ms: int = 80):
    """Animated GIF of the fit trajectory (the reference HPRenderer's fit
    video, ``optim/fit.py`` / ``optim/renderer.py:104-156``): the
    Phong-shaded object at every ``every``-th step and the last, over the
    target mask in red. ``scene`` holds tensors on the render device."""
    from PIL import Image

    target = scene["target_mask"].float().cpu().numpy()
    if target.shape[0] != image_size:
        ys = (np.arange(image_size) * target.shape[0] / image_size).astype(int)
        xs = (np.arange(image_size) * target.shape[1] / image_size).astype(int)
        target = target[ys][:, xs]
    bg = np.zeros((image_size, image_size, 3), np.float32)
    bg[..., 0] = 0.55 * target  # the target mask in red

    n_steps = int(params_hist.translation.shape[0])
    idxs = list(range(0, n_steps, max(1, every)))
    if idxs[-1] != n_steps - 1:
        idxs.append(n_steps - 1)
    frames = []
    for i in idxs:
        v = apply_transformation(scene["obj_verts"], params_hist.rot6d[i],
                                 params_hist.translation[i],
                                 torch.exp(params_hist.log_scale[i]))
        rgba = render_phong(v + scene["centroid_offset"], scene["obj_faces"],
                            scene["focal"], scene["princpt"], image_size
                            ).cpu().numpy()
        a = rgba[..., 3:4] * 0.85
        frame = bg * (1 - a) + rgba[..., :3] * a
        frames.append(Image.fromarray((np.clip(frame, 0, 1) * 255
                                       ).astype(np.uint8)))
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   duration=duration_ms, loop=0)
    return path
