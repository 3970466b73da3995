"""Per-dataset offline datagen recipes: the on-disk trees the datasets read.

Port of ``interactvlm_tpu/datagen/recipes.py`` (the reference's
``preprocess_data/generate_damon_human_mask.py``,
``generate_lemon_human_mask.py``, ``generate_rich_human_mask.py``,
``generate_piad_obj_heatmap.py`` and ``generate_pico_obj_mask.py``). Each
recipe writes the tree its dataset in ``data/datasets.py`` reads, file for
file as the JAX package writes it, so a tree written by either package
loads in both:

- DAMON (``hcontact_vitruvian_mv2``): grey canonical-body renders and their
  lift maps, one contact mask per (image, object, view), body-part names
  at >= 10 % segmentation coverage (:74-95), and the ``foot_ground`` subset
  carved from 'supporting' contacts restricted to the foot parts
  (:213-224);
- LEMON-HU (``lemon/``): per-image per-vertex contacts, masks, body parts
  and the split list, beside the shared canonical body;
- RICH: the DAMON recipe with every contact keyed to 'scene'
  (hcontactScene_3d.py:53);
- PIAD / LEMON objects (``rendered_points_heatmap``): the txt point files
  (generate_piad_obj_heatmap.py:15-30, generate_lemon_obj_heatmap.py:15-30)
  as position-RGB renders, affordance heatmaps, pixel -> point maps and
  ``index.pkl``;
- PICO (``pico_ocontact``): grey mesh renders, binary contact masks,
  per-object pixel -> vertex maps and ``index.pkl``.

Rasterization, lift maps, point splats and contact masks run on
``device`` (the card unless the caller names the CPU, or the device of the
vertices when they are a tensor; ``generate.pick_device``); shading, PNG
and pickle writing run on the host. Pickles and npz files hold numpy
arrays, never tensors.
"""

from __future__ import annotations

import os
import pickle
from os.path import basename, join, splitext
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from interactvlm_tpu_torch.datagen.generate import (
    contact_views,
    generate_object_assets,
    host,
    lift_maps_on,
    pick_device,
)
from interactvlm_tpu_torch.demo.demo_utils import shaded_render
from interactvlm_tpu_torch.geometry.views import ViewSet

# Affordance vocabularies (reference preprocess_data/constants.py:5-59 --
# data schema constants, required for txt-column indexing parity).
AFFORD_LIST_PIAD = np.array([
    "grasp", "contain", "lift", "open", "lay", "sit", "support", "wrapgrasp",
    "pour", "move", "display", "push", "listen", "wear", "press", "cut",
    "stab",
])
AFFORD_LIST_LEMON = np.array([
    "grasp", "contain", "lift", "open", "lay", "sit", "support", "wrapgrasp",
    "pour", "move", "display", "press", "stab",
])
FOOT_PARTS = ("left foot", "right foot")


# --- txt point-file parsers -------------------------------------------------
def extract_point_file_piad(path: str):
    """PIAD txt rows: ``<idx> <objname> x y z a_1 ... a_17``
    (reference generate_piad_obj_heatmap.py:15-30).
    Returns (points (N, 3), affordance (N, 17), obj_name)."""
    coords = []
    obj_name = "object"
    with open(path) as f:
        for line in f:
            data = line.strip().split(" ")
            if len(data) < 5:
                continue
            obj_name = data[1]
            coords.append([float(x) for x in data[2:]])
    arr = np.asarray(coords, np.float64)
    return arr[:, 0:3], arr[:, 3:], obj_name


def extract_point_file_lemon(path: str):
    """LEMON txt rows: ``x y z a_1 ... a_13``; object name from the
    filename prefix (reference generate_lemon_obj_heatmap.py:15-30)."""
    coords = []
    with open(path) as f:
        for line in f:
            data = line.strip().split(" ")
            if len(data) < 4:
                continue
            coords.append([float(x) for x in data])
    arr = np.asarray(coords, np.float64)
    obj_name = basename(path).split("_")[0]
    return arr[:, 0:3], arr[:, 3:], obj_name


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


def _to_uint8(x: np.ndarray) -> np.ndarray:
    """[0, 1] values as PNG levels, truncated as the JAX package writes
    them."""
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def _grey_body_renders(verts, faces, view_set: ViewSet, image_size: int,
                       device):
    """Grey shaded canonical-body renders on white background (the
    reference's grey sam_input_type renders; white = invalid region for
    ``valid_region_mask``). Returns (renders (V,S,S,3) uint8, p2v, bary,
    p2f), the maps as tensors on ``device``."""
    p2v, bary, p2f = lift_maps_on(verts, faces, view_set, image_size, device)
    verts_dev = torch.as_tensor(host(verts, np.float32), device=device)
    faces_np = host(faces)
    renders = []
    for v in range(view_set.num_views):
        # (S, S, 3) uint8, white background, lambert-shaded body
        hit = host(p2f[v] >= 0)
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
    np.savez_compressed(join(out_root, "lift_maps.npz"), p2v=host(p2v),
                        bary=host(bary))
    return p2v, bary, p2f


def _contact_masks_png(out_dir: str, prefix: str, p2f, faces, contact_ids,
                       n_verts, view_set: ViewSet, min_vertices: int = 2):
    """The GT contact mask of ``contact_ids`` under each view, as
    ``{prefix}_{view}.png`` (0 / 255) under ``out_dir``."""
    cmask = np.zeros(n_verts, bool)
    ids = np.asarray(contact_ids).reshape(-1)
    cmask[ids[ids < n_verts]] = True
    masks = host(contact_views(p2f, faces, cmask, min_vertices))
    for v, name in enumerate(view_set.names):
        _save_png(join(out_dir, f"{prefix}_{name}.png"),
                  (masks[v] * 255).astype(np.uint8))


def _extend_index(folder: str, split: str, records):
    """Add ``records`` to ``split`` of the tree's ``index.pkl``, creating
    it with empty train and test splits."""
    index_path = join(folder, "index.pkl")
    index = {"train": [], "test": []}
    if os.path.exists(index_path):
        index = _load_index(index_path)
    index.setdefault(split, [])
    index[split].extend(records)
    os.makedirs(folder, exist_ok=True)
    with open(index_path, "wb") as f:
        pickle.dump(index, f)


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
    device = pick_device(verts, device)
    out_root = join(root, "hcontact_vitruvian_mv2")
    p2v, bary, p2f = _write_human_tree(out_root, verts, faces, view_set,
                                       image_size, device)
    n_verts = verts.shape[0]
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
            _contact_masks_png(join(out_root, "masks"), f"{stem}_{obj}", p2f,
                               faces, ids, n_verts, view_set, min_vertices)
            # DAMON has no explicit foot-ground: carve it from 'supporting'
            # restricted to the foot parts (:213-224)
            if "supporting" in obj:
                sub = get_contact_subset(ids, merged_segm, FOOT_PARTS)
                if sub.size:
                    new_annot[image_name]["foot_ground"] = sub
                    body_parts[image_name]["foot_ground"] = parts
                    _contact_masks_png(
                        join(out_root, "masks"), f"{stem}_foot_ground", p2f,
                        faces, sub, n_verts, view_set, min_vertices)
    with open(join(out_root, "contact_label_objectwise.pkl"), "wb") as f:
        pickle.dump(new_annot, f)
    with open(join(out_root, "body_parts_objectwise.pkl"), "wb") as f:
        pickle.dump(body_parts, f)
    return {"annot": new_annot, "body_parts": body_parts,
            "p2v": host(p2v), "bary": host(bary)}


# --- LEMON-HU -------------------------------------------------------------------
def generate_lemon_human_tree(
    root: str,
    contacts: Dict[str, np.ndarray],
    verts,
    faces,
    view_set: ViewSet,
    image_size: int,
    merged_segm: Dict[str, Sequence[int]],
    split: str = "train",
    min_vertices: int = 2,
    device=None,
):
    """LEMON-HU datagen -> the ``lemon/`` tree that the HContactDataset
    LEMON branch reads (generate_lemon_human_mask.py): per-image per-vertex
    contact pkls, masks, body-part pkl, split txt; the canonical body's
    renders and lift maps under ``hcontact_vitruvian_mv2`` beside it, so a
    LEMON-only tree is self-sufficient. ``device`` as in
    ``generate_damon_tree``."""
    device = pick_device(verts, device)
    lm = join(root, "lemon")
    out_root = join(root, "hcontact_vitruvian_mv2")
    _, _, p2f = _write_human_tree(out_root, verts, faces, view_set,
                                  image_size, device)
    n_verts = verts.shape[0]
    os.makedirs(join(lm, "txt_scripts"), exist_ok=True)
    os.makedirs(join(lm, "contact"), exist_ok=True)
    names, parts_map = [], {}
    for image_name, contact in sorted(contacts.items()):
        contact = np.asarray(contact, np.float32).reshape(-1)
        stem = splitext(basename(image_name))[0]
        if contact.nonzero()[0].size == 0:
            continue  # reference skips zero-contact (:167-169)
        with open(join(lm, "contact", f"{stem}.pkl"), "wb") as f:
            pickle.dump(contact, f)
        ids = np.where(contact > 0)[0]
        parts_map[stem] = get_body_parts_from_vertices(ids, merged_segm)
        _contact_masks_png(join(lm, "masks"), stem, p2f, faces, ids,
                           n_verts, view_set, min_vertices)
        names.append(image_name)
    with open(join(lm, "txt_scripts", f"{split}.txt"), "w") as f:
        f.write("\n".join(names) + ("\n" if names else ""))
    with open(join(lm, f"body_parts_{split}.pkl"), "wb") as f:
        pickle.dump(parts_map, f)
    return {"images": names, "body_parts": parts_map}


# --- RICH (scene) ----------------------------------------------------------------
def generate_rich_tree(
    root: str,
    contact_annot: Dict[str, np.ndarray],
    verts,
    faces,
    view_set: ViewSet,
    image_size: int,
    merged_segm: Dict[str, Sequence[int]],
    min_vertices: int = 2,
    device=None,
):
    """RICH scene-contact datagen (generate_rich_human_mask.py): the DAMON
    recipe with every annotation keyed to the single 'scene' class
    (hcontactScene_3d.py:53)."""
    annot = {
        img: {"scene": np.asarray(ids).reshape(-1)}
        for img, ids in contact_annot.items()
    }
    return generate_damon_tree(root, annot, verts, faces, view_set,
                               image_size, merged_segm, min_vertices,
                               device=device)


# --- PIAD / LEMON object affordance ------------------------------------------------
def generate_piad_tree(
    root: str,
    point_files: Dict[str, str],
    view_set: ViewSet,
    image_size: int,
    split: str = "train",
    dataset: str = "piad",
    image_for: Optional[Dict[str, str]] = None,
    object_matches: Optional[Dict[str, Sequence[str]]] = None,
    affordance: str = "sit",
    radius: int = 2,
    device=None,
):
    """PIAD/LEMON object affordance datagen -> the
    ``rendered_points_heatmap`` tree ``OAffordDataset`` reads
    (generate_piad_obj_heatmap.py / generate_lemon_obj_heatmap.py):
    position-RGB renders, affordance heatmaps, p2p maps, gt npz, index.pkl
    (with the OpenShape ``object_matches`` ranking attached when given).
    The splats run on ``device`` (None = the card).

    ``point_files``: {object_id: txt path}. Returns the split's new
    records."""
    device = pick_device(None, device)
    folder = join(root, "rendered_points_heatmap")
    afford_list = AFFORD_LIST_PIAD if dataset == "piad" else AFFORD_LIST_LEMON
    col = int(np.argwhere(afford_list == affordance).item())
    extract = (
        extract_point_file_piad if dataset == "piad"
        else extract_point_file_lemon
    )
    records = []
    for oid, path in sorted(point_files.items()):
        pts, labels, obj_name = extract(path)
        gt = labels[:, col].astype(np.float32)
        assets = generate_object_assets(pts, view_set, image_size,
                                        affordance=gt, radius=radius,
                                        device=device)
        for i, vname in enumerate(view_set.names):
            _save_png(join(folder, "renders", f"{oid}_{vname}.png"),
                      _to_uint8(assets["renders"][i]))
            _save_png(join(folder, "heatmaps", f"{oid}_{vname}.png"),
                      _to_uint8(assets["heatmaps"][i]))
        os.makedirs(join(folder, "gt"), exist_ok=True)
        np.savez_compressed(join(folder, "gt", f"{oid}.npz"), affordance=gt)
        os.makedirs(join(folder, "maps"), exist_ok=True)
        np.savez_compressed(join(folder, "maps", f"{oid}.npz"),
                            p2p=assets["p2p"])
        rec = {
            "image": (image_for or {}).get(oid, f"{oid}.jpg"),
            "object_id": oid,
            "class_name": obj_name,
            "affordance": affordance,
        }
        if object_matches and oid in object_matches:
            rec["object_matches"] = list(object_matches[oid])
        records.append(rec)
    _extend_index(folder, split, records)
    return records


# --- PICO object mesh contact -----------------------------------------------------
def generate_pico_tree(
    root: str,
    meshes: Dict[str, Dict],
    view_set: ViewSet,
    image_size: int,
    split: str = "train",
    min_vertices: int = 2,
    device=None,
):
    """PICO low-poly mesh contact datagen -> the ``pico_ocontact`` tree
    ``OContactDataset`` reads (generate_pico_obj_mask.py): grey mesh
    renders, binary contact masks, per-object p2v/bary maps, gt npz with
    the vertex count. Rasterized on ``device`` (None = the card).

    ``meshes``: {object_id: {verts, faces, contact (N,), image,
    class_name}}. Returns the split's new records."""
    device = pick_device(None, device)
    folder = join(root, "pico_ocontact")
    records = []
    for oid, m in sorted(meshes.items()):
        verts = host(m["verts"], np.float32)
        faces = host(m["faces"], np.int32)
        contact = host(m["contact"], np.float32).reshape(-1)
        renders, p2v, bary, p2f = _grey_body_renders(verts, faces, view_set,
                                                     image_size, device)
        for v, vname in enumerate(view_set.names):
            _save_png(join(folder, "renders", f"{oid}_{vname}.png"),
                      renders[v])
        _contact_masks_png(join(folder, "masks"), oid, p2f, faces,
                           np.where(contact > 0)[0], contact.size, view_set,
                           min_vertices)
        os.makedirs(join(folder, "gt"), exist_ok=True)
        np.savez_compressed(join(folder, "gt", f"{oid}.npz"),
                            contact=contact, n_verts=np.int32(len(verts)))
        os.makedirs(join(folder, "maps"), exist_ok=True)
        np.savez_compressed(join(folder, "maps", f"{oid}.npz"),
                            p2v=host(p2v), bary=host(bary))
        records.append({
            "image": m.get("image", f"{oid}.jpg"),
            "object_id": oid,
            "class_name": m.get("class_name", "object"),
        })
    _extend_index(folder, split, records)
    return records


def _load_index(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)
