"""Demo-time render helpers (the part of
``interactvlm_tpu/demo/demo_utils.py`` the datagen recipes need)."""

from __future__ import annotations

import numpy as np
import torch

from interactvlm_tpu_torch.fit.utils import compute_vertex_normals


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
