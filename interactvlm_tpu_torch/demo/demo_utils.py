"""Demo-time utilities: on-the-fly object views, lift dicts and outputs.

Port of ``interactvlm_tpu/demo/demo_utils.py`` (the reference's
``utils/demo_utils.py``):
- ``generate_sam_inp_objs`` (reference :171-257): normalise an object
  mesh, render its four canonical views (``shaded_render`` on the port's
  lift maps, rasterized on the card unless the caller names the CPU) and
  write the ``lift2d_dict.pkl`` of per-view pixel -> vertex and
  barycentric maps the object-contact path lifts with;
- the contact-coloured OBJ export (reference :30-123);
- the SMPL -> SMPL-X contact transfer by the sparse mapping matrix
  (reference utils/utils.py:428-443);
- the mask overlays of the demo's output bundle (reference
  run_demo.py:499-558).
"""

from __future__ import annotations

import os
import pickle
from os.path import join
from typing import Dict

import numpy as np
import torch

from interactvlm_tpu_torch.fit.data_io import save_obj_mesh
from interactvlm_tpu_torch.fit.utils import compute_vertex_normals
from interactvlm_tpu_torch.geometry.lift import corner_major
from interactvlm_tpu_torch.geometry.rasterizer import (
    build_lift_maps,
    pick_window,
)
from interactvlm_tpu_torch.geometry.views import OBJECT_VIEWS
from interactvlm_tpu_torch.utils.device import resolve_device


def normalize_mesh(verts: np.ndarray):
    """Centre at the origin and scale into the unit sphere (reference
    demo_utils.py:128-143). Returns (verts f32, centre, scale)."""
    c = (verts.max(0) + verts.min(0)) / 2.0
    v = verts - c
    scale = np.linalg.norm(v, axis=1).max()
    return (v / max(scale, 1e-8)).astype(np.float32), c, scale


def shaded_render(verts, faces, pix_to_face, p2v=None, bary=None,
                  light_dir=(0.3, 0.4, 0.8), specular: float = 0.25,
                  shininess: float = 24.0):
    """Grey render of a rasterization (the demo's object views; reference
    HardPhongShader renders, demo_utils.py:171-257), as uint8 (S, S, 3) on
    a white background.

    With per-pixel vertex / bary maps (from ``build_lift_maps``) normals
    are barycentric-interpolated per pixel (smooth Phong with a specular
    lobe); without them, flat per-face Lambert. The normals come from
    ``compute_vertex_normals`` on the device of ``verts`` (a tensor) or the
    CPU; the shading is the JAX package's numpy."""
    if not torch.is_tensor(verts):
        verts = torch.as_tensor(np.asarray(verts, np.float32))
    faces_t = torch.as_tensor(np.asarray(faces), device=verts.device) \
        if not torch.is_tensor(faces) else faces.to(verts.device)
    normals = compute_vertex_normals(verts, faces_t).cpu().numpy()
    faces = faces_t.cpu().numpy()
    light = np.asarray(light_dir, np.float32)
    light /= np.linalg.norm(light)
    p2f = (pix_to_face.cpu().numpy() if torch.is_tensor(pix_to_face)
           else np.asarray(pix_to_face))
    img = np.ones(p2f.shape + (3,), np.float32)
    hit = p2f >= 0
    if p2v is not None and bary is not None:
        p2v = np.asarray(p2v)[hit]          # (P, 3) vertex ids
        w = np.asarray(bary)[hit]           # (P, 3)
        n = (normals[p2v] * w[..., None]).sum(1)
        n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-8)
        # two-sided; view direction is +z toward the camera in view space
        n[n[:, 2] < 0] *= -1.0
        lam = np.clip(n @ light, 0, 1)
        refl = 2.0 * lam[:, None] * n - light[None]
        spec = np.clip(refl[:, 2], 0, 1) ** shininess
        shade = 0.35 + 0.55 * lam + specular * spec
        img[hit] = np.clip(shade, 0, 1)[:, None]
    else:
        face_n = normals[faces].mean(1)
        face_n /= np.maximum(
            np.linalg.norm(face_n, axis=1, keepdims=True), 1e-8
        )
        shade = 0.35 + 0.65 * np.clip(face_n @ light, 0, 1)
        img[hit] = shade[p2f[hit], None]
    return (img * 255).astype(np.uint8)


def generate_sam_inp_objs(verts: np.ndarray, faces: np.ndarray, out_dir: str,
                          view_type: str = "4MV-Z_HM_MeshInf",
                          image_size: int = 1024, device="cuda"):
    """Render the canonical object views and write the lift dict
    (reference demo_utils.py:171-257: grey renders + lift2d_dict.pkl). The
    maps and the normals are built on ``device`` (the card unless the
    caller names the CPU). Returns (render paths, the pickle's path)."""
    from PIL import Image

    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    view_set = OBJECT_VIEWS[view_type]
    nverts, _, _ = normalize_mesh(verts)
    cams = view_set.cam_params()
    w = max(pick_window(nverts, faces, c, image_size) for c in cams)
    p2v, bary, p2f = build_lift_maps(nverts, faces, cams, image_size, w,
                                     device=device)
    vt = torch.as_tensor(nverts, device=p2v.device)
    p2v, bary = p2v.cpu().numpy(), bary.cpu().numpy()
    render_paths = []
    for i, name in enumerate(view_set.names):
        img = shaded_render(vt, faces, p2f[i], p2v=p2v[i], bary=bary[i])
        path = join(out_dir, f"{name}.png")
        Image.fromarray(img).save(path)
        render_paths.append(path)
    lift2d = {"num_vertices": int(nverts.shape[0]),
              "pixel_to_vertices_map": list(p2v),
              "bary_coords_map": list(bary)}
    with open(join(out_dir, "lift2d_dict.pkl"), "wb") as f:
        pickle.dump(lift2d, f)
    return render_paths, join(out_dir, "lift2d_dict.pkl")


def load_lift2d_dict(path: str) -> Dict:
    """The pickled lift maps as corner-major (3, V, H, W) CPU tensors
    (``geometry/lift.py:corner_major``) and the vertex count."""
    with open(path, "rb") as f:
        d = pickle.load(f)
    return {"p2v": torch.from_numpy(
                corner_major(np.stack(d["pixel_to_vertices_map"]))),
            "bary": torch.from_numpy(
                corner_major(np.stack(d["bary_coords_map"]))),
            "num_vertices": int(d["num_vertices"])}


def export_contact_obj(path: str, verts, faces, contact,
                       threshold: float = 0.5, base_color=(0.8, 0.8, 0.8),
                       contact_color=(1.0, 0.15, 0.1)):
    """Write an OBJ whose contact vertices are coloured red, blended by how
    far the contact passes ``threshold`` (reference demo_utils.py:30-123)."""
    contact = np.asarray(contact).reshape(-1)
    t = np.clip((contact - threshold) / max(1 - threshold, 1e-6), 0, 1)
    colors = (np.asarray(base_color)[None] * (1 - t[:, None])
              + np.asarray(contact_color)[None] * t[:, None])
    save_obj_mesh(path, verts, faces, colors)


def load_smpl_to_smplx_mapping(path: str) -> np.ndarray:
    """The (10475, 6890) transfer matrix pickle, dense f32 (reference
    SMPL_TO_SMPLX_MAPPING, utils/utils.py:428-443)."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    m = data["matrix"] if isinstance(data, dict) and "matrix" in data else data
    if hasattr(m, "toarray"):
        m = m.toarray()
    return np.asarray(m, np.float32)


def convert_contacts_smpl_to_smplx(contacts, mapping: np.ndarray):
    """(B?, 6890) SMPL contacts -> (B?, 10475) SMPL-X by the mapping
    matrix product (reference utils/utils.py:428-443)."""
    c = np.asarray(contacts, np.float32)
    single = c.ndim == 1
    out = (c[None] if single else c) @ mapping.T
    return out[0] if single else out


def overlay_mask(img, mask, alpha: float = 0.5, color=(255, 38, 25)):
    """One mask overlay (reference run_demo.py:499-515): img (H, W, 3)
    uint8, mask (H, W) probabilities."""
    over = np.asarray(img).astype(np.float32)
    mm = (np.asarray(mask) > 0.5)[..., None]
    over = np.where(mm, (1 - alpha) * over
                    + alpha * np.asarray(color, np.float32), over)
    return over.astype(np.uint8)


def overlay_grid(renders, masks, alpha: float = 0.5, color=(255, 38, 25)):
    """2 x 2 grid of mask overlays on the view renders (reference
    run_demo.py:516-558): renders (4, H, W, 3) uint8, masks (4, H, W)
    probabilities. Fewer than 4 images concatenate in one row."""
    out = [overlay_mask(i, m, alpha, color)
           for i, m in zip(np.asarray(renders), np.asarray(masks))]
    if len(out) == 1:
        return out[0]
    if len(out) < 4:
        return np.concatenate(out, axis=1)
    return np.concatenate([np.concatenate(out[:2], axis=1),
                           np.concatenate(out[2:4], axis=1)], axis=0)
