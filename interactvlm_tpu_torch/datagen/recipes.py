"""The DAMON datagen recipe: the on-disk tree ``HContactDataset`` reads.

Port of the DAMON part of ``interactvlm_tpu/datagen/recipes.py`` (reference
``preprocess_data/generate_damon_human_mask.py``): grey canonical-body
renders and their lift maps, one contact mask per (image, object, view),
body-part names at >= 10 % segmentation coverage (:74-95), and DAMON's
``foot_ground`` subset carved from 'supporting' contacts restricted to the
foot parts (:213-224). The rasterization, the lift maps and the contact
masks run on ``device`` (the card unless the caller names the CPU, or the
device of ``verts`` when it is a tensor) through ``geometry/rasterizer.py``;
shading and PNG writing run on the host.
"""

from __future__ import annotations

import os
import pickle
from os.path import basename, join, splitext
from typing import Dict, Sequence

import numpy as np
import torch

from interactvlm_tpu_torch.demo.demo_utils import shaded_render
from interactvlm_tpu_torch.geometry.rasterizer import (
    build_lift_maps,
    contact_mask_from_fragments,
    pick_window,
)
from interactvlm_tpu_torch.geometry.views import ViewSet
from interactvlm_tpu_torch.utils.device import resolve_device

FOOT_PARTS = ("left foot", "right foot")


# --- body-part naming --------------------------------------------------------
def get_body_parts_from_vertices(
    vertex_ids, merged_segm: Dict[str, Sequence[int]], threshold: float = 0.1
):
    """Part names whose vertex set is covered >= ``threshold`` by the
    contact set (reference generate_damon_human_mask.py:74-95)."""
    vset = set(int(v) for v in np.asarray(vertex_ids).reshape(-1))
    parts = []
    for part, part_vertices in merged_segm.items():
        pset = set(int(v) for v in part_vertices)
        if pset and len(vset & pset) / len(pset) >= threshold:
            parts.append(part)
    return parts


def get_contact_subset(
    vertex_ids, merged_segm: Dict[str, Sequence[int]],
    parts: Sequence[str],
):
    """Contact vertices restricted to the given body parts
    (reference generate_damon_human_mask.py:97-110)."""
    keep = set()
    for p in parts:
        keep.update(int(v) for v in merged_segm.get(p, ()))
    ids = np.asarray(vertex_ids).reshape(-1)
    return ids[np.isin(ids, sorted(keep))]


# --- shared writers -----------------------------------------------------------
def _save_png(path: str, arr: np.ndarray):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _grey_body_renders(verts, faces, view_set: ViewSet, image_size: int,
                       device):
    """Grey shaded canonical-body renders on white background (the
    reference's grey sam_input_type renders; white = invalid region for
    ``valid_region_mask``). Returns (renders (V,S,S,3) uint8, p2v, bary,
    p2f), the maps as tensors on ``device``."""
    cams = view_set.cam_params()
    verts_np = (verts.cpu().numpy() if torch.is_tensor(verts)
                else np.asarray(verts, np.float32))
    faces_np = (faces.cpu().numpy() if torch.is_tensor(faces)
                else np.asarray(faces))
    w = max(pick_window(verts_np, faces_np, c, image_size) for c in cams)
    p2v, bary, p2f = build_lift_maps(verts_np, faces_np, cams, image_size, w,
                                     device=device)
    verts_dev = torch.as_tensor(verts_np, device=device)
    renders = []
    for v in range(view_set.num_views):
        # (S, S, 3) uint8, white background, lambert-shaded body
        hit = (p2f[v] >= 0).cpu().numpy()
        img = shaded_render(verts_dev, faces_np, p2f[v])
        # cap body brightness below 255 so valid_region_mask (non-white)
        # always includes the body
        img[hit] = np.minimum(img[hit], 250)
        renders.append(img)
    return np.stack(renders), p2v, bary, p2f


def _write_human_tree(out_root: str, verts, faces, view_set: ViewSet,
                      image_size: int, device):
    """Shared human-canonical-body outputs: renders + lift maps."""
    renders, p2v, bary, p2f = _grey_body_renders(
        verts, faces, view_set, image_size, device)
    for i, name in enumerate(view_set.names):
        _save_png(join(out_root, "renders", f"{name}.png"), renders[i])
    os.makedirs(out_root, exist_ok=True)
    np.savez_compressed(join(out_root, "lift_maps.npz"),
                        p2v=p2v.cpu().numpy(), bary=bary.cpu().numpy())
    return p2v, bary, p2f


def _contact_masks_png(
    out_dir: str, stem: str, obj: str, p2f, faces, contact_ids, n_verts,
    view_set: ViewSet, min_vertices: int = 2,
):
    cmask = torch.zeros(n_verts, dtype=torch.bool, device=p2f.device)
    ids = torch.as_tensor(np.asarray(contact_ids).reshape(-1),
                          device=p2f.device).long()
    cmask[ids[ids < n_verts]] = True
    for v, name in enumerate(view_set.names):
        m = contact_mask_from_fragments(p2f[v], faces, cmask,
                                        min_vertices).cpu().numpy()
        _save_png(
            join(out_dir, f"{stem}_{obj}_{name}.png"),
            (m * 255).astype(np.uint8),
        )


# --- DAMON --------------------------------------------------------------------
def generate_damon_tree(
    root: str,
    contact_annot: Dict[str, Dict[str, np.ndarray]],
    verts,
    faces,
    view_set: ViewSet,
    image_size: int,
    merged_segm: Dict[str, Sequence[int]],
    min_vertices: int = 2,
    device=None,
):
    """DAMON human-contact datagen -> the ``hcontact_vitruvian_mv2`` tree
    that ``HContactDataset`` reads (generate_damon_human_mask.py):
    per-(image, object) masks, body-part names at >=10% segmentation
    coverage, and the foot_ground subset derived from 'supporting'.

    ``device``: where the rasterizer, the normals and the contact masks
    run; None = the device of ``verts`` when it is a tensor, else the card.
    Returns the annotations, the body parts and the lift maps (p2v, bary
    (V, S, S, 3) on the host)."""
    if device is None:
        device = verts.device if torch.is_tensor(verts) else "cuda"
    device = resolve_device(device)
    out_root = join(root, "hcontact_vitruvian_mv2")
    p2v, bary, p2f = _write_human_tree(out_root, verts, faces, view_set,
                                       image_size, device)
    n_verts = verts.shape[0]
    faces_dev = torch.as_tensor(
        faces.cpu().numpy() if torch.is_tensor(faces) else np.asarray(faces),
        device=device)
    new_annot: Dict[str, Dict[str, np.ndarray]] = {}
    body_parts: Dict[str, Dict[str, list]] = {}
    for image_name, objs in sorted(contact_annot.items()):
        # reference keys masks by the image BASENAME (hcontact_3d.py:61:
        # base_name = os.path.basename(llava_image)[:-4]) -- must match the
        # loader's stem for path-qualified image names (e.g. RICH frames)
        stem = splitext(basename(image_name))[0]
        for obj, ids in sorted(objs.items()):
            ids = np.asarray(ids).reshape(-1)
            if ids.size == 0:
                continue  # reference skips empty contacts (:196-204)
            parts = get_body_parts_from_vertices(ids, merged_segm)
            new_annot.setdefault(image_name, {})[obj] = ids
            body_parts.setdefault(image_name, {})[obj] = parts
            _contact_masks_png(
                join(out_root, "masks"), stem, obj, p2f, faces_dev, ids,
                n_verts, view_set, min_vertices,
            )
            # DAMON has no explicit foot-ground: carve it from 'supporting'
            # restricted to the foot parts (:213-224)
            if "supporting" in obj:
                sub = get_contact_subset(ids, merged_segm, FOOT_PARTS)
                if sub.size:
                    new_annot[image_name]["foot_ground"] = sub
                    body_parts[image_name]["foot_ground"] = parts
                    _contact_masks_png(
                        join(out_root, "masks"), stem, "foot_ground", p2f,
                        faces_dev, sub, n_verts, view_set, min_vertices,
                    )
    with open(join(out_root, "contact_label_objectwise.pkl"), "wb") as f:
        pickle.dump(new_annot, f)
    with open(join(out_root, "body_parts_objectwise.pkl"), "wb") as f:
        pickle.dump(body_parts, f)
    return {"annot": new_annot, "body_parts": body_parts,
            "p2v": p2v.cpu().numpy(), "bary": bary.cpu().numpy()}
