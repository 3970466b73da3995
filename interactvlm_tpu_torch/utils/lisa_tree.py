"""Seeded trees in the LISA corpora's on-disk layouts, for tests and the
card's smoke run: what ``data/datasets.py``'s LISA datasets read.

``write_lisa_tree(root, ...)`` writes, from one ``np.random.default_rng``
seed:

  ade20k/               ade20k_classes.json; images/training/*.jpg and
                        annotations/training/*.png ("L" id maps, 0 =
                        unlabeled; the last map is all unlabeled, so the
                        dataset falls through to the next item)
  cocostuff/, coco/     cocostuff_classes.txt ("id: name", a header line;
                        "-" classes the dataset ignores), train2017 label
                        PNGs (255 = unlabeled) and their photos
  mapillary/            config_v2.0.json and "P" mode label PNGs
  vlpart/paco/, coco/   paco_lvis_v1_train.json ("obj_(x):part_(y)" parts,
                        polygon and compressed-RLE annotations)
  vlpart/pascal_part/   train.json and VOCdevkit/VOC2010/JPEGImages
  refer_seg/            refcoco (refs(unc).p), refcocog (refs(umd).p) and
                        refclef, each with instances.json (polygon and
                        compressed-RLE annotations, G_REFER-style ann_id
                        lists, one of them empty, train and val refs);
                        images under images/mscoco/images/train2014 and
                        images/saiapr_tc-12; refcoco/index.pkl and masks/
                        (``ReferSegDataset``: RLE or a mask PNG)
  reason_seg/index.pkl  polygon records, long and short questions, some
                        with explanations, train and val
  sem_seg/ade20k/       index.pkl and labels/ (``SemSegDataset``)
  images/               the photos of the index layouts
  vqa.pkl               VQA records

Photo sizes are the corpora's, times ``scale``: 683 x 512 (ade20k),
640 x 480 (COCO, refcoco), mixed sizes for ReasonSeg.
"""

from __future__ import annotations

import json
import os
import pickle
from os.path import join
from typing import Dict, List

import numpy as np

ADE_CLASSES = ["wall", "building", "sky", "floor", "tree", "ceiling",
               "road", "bed", "windowpane", "grass", "cabinet", "sidewalk"]
COCOSTUFF_CLASSES = ["person", "grass-merged", "tree", "sky-other-merged",
                     "car", "wall-brick"]
MAPILLARY_CLASSES = ["Road", "Car", "Sky", "Person", "Traffic Sign"]
PACO_CATEGORIES = [(1, "chair_(furniture):leg_(limb)"),
                   (2, "table_(furniture)"), (3, "mug:handle_(grip)"),
                   (4, "bottle:cap_(lid)")]
REASON_SIZES = ((640, 480), (1024, 768), (500, 375), (800, 600))
REFER_NOUNS = ("man", "woman", "dog", "chair", "car", "table", "cup",
               "bike")


def rle_encode(mask: np.ndarray) -> Dict:
    """A binary (h, w) mask as COCO compressed RLE (pycocotools'
    ``rleToString``): column-major run lengths, each after the second
    taken less the one two before it, in 5-bit groups with a continue bit,
    offset by 48."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).T.reshape(-1)
    counts, prev, run = [], 0, 0
    for v in flat:
        if v == prev:
            run += 1
        else:
            counts.append(run)
            prev, run = v, 1
    counts.append(run)
    out = bytearray()
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not c & 0x10) or (x == -1 and c & 0x10))
            if more:
                c |= 0x20
            out.append(c + 48)
    return {"size": [h, w], "counts": out.decode()}


def _save(path, arr, mode=None, **kw):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    im = Image.fromarray(arr)
    if mode == "P":
        im = im.convert("P")
        im.putpalette([v for i in range(256) for v in (i, 255 - i, i // 2)])
    im.save(path, **kw)


def _photo(rng, w, h):
    return rng.integers(0, 255, (h, w, 3), dtype=np.uint8)


def _blobs(rng, h, w, ids: List[int], background: int):
    """An (h, w) uint8 id map: ``background`` with a rectangle of each id."""
    lab = np.full((h, w), background, np.uint8)
    for cid in ids:
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        lab[y0:y0 + int(rng.integers(2, h // 2 + 2)),
            x0:x0 + int(rng.integers(2, w // 2 + 2))] = cid
    return lab


def polygon(rng, w, h, n=None, off_image=False):
    """A flat [x0, y0, x1, y1, ...] star polygon (concave from 8 points up)
    around a random centre; some vertices on pixel centres (x.5), and with
    ``off_image`` its first vertex past the image's corner."""
    n = n or int(rng.integers(5, 10))
    cx, cy = rng.uniform(0.3, 0.7) * w, rng.uniform(0.3, 0.7) * h
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = rng.uniform(0.1, 0.35, n) * min(w, h)
    rad[1::2] *= 0.5  # every other vertex pulled in: concave
    xs, ys = cx + rad * np.cos(ang), cy + rad * np.sin(ang)
    xs[::3] = np.floor(xs[::3]) + 0.5
    ys[::3] = np.floor(ys[::3]) + 0.5
    if off_image:
        xs[0], ys[0] = -3.0, -2.0
    return [float(v) for xy in zip(xs, ys) for v in xy]


def _poly_mask(poly, h, w):
    from interactvlm_tpu_torch.data.datasets import fill_polygon

    return fill_polygon(poly, h, w)


def _size(wh, scale):
    return max(16, int(round(wh[0] * scale))), max(16, int(round(wh[1]
                                                                  * scale)))


def write_lisa_tree(root: str, seed: int = 0, n_ade: int = 16,
                    n_refcoco: int = 16, n_reason: int = 8, n_other: int = 2,
                    n_vqa: int = 8, scale: float = 1.0) -> Dict[str, int]:
    """Write the LISA trees under ``root`` (see the module docstring).
    Returns the number of records of each corpus."""
    rng = np.random.default_rng(seed)
    jpg = dict(quality=90)

    # --- ade20k
    d = join(root, "ade20k")
    os.makedirs(d, exist_ok=True)
    with open(join(d, "ade20k_classes.json"), "w") as f:
        json.dump(ADE_CLASSES, f)
    w, h = _size((683, 512), scale)
    for i in range(n_ade):
        _save(join(d, "images", "training", f"ADE_train_{i:08d}.jpg"),
              _photo(rng, w, h), **jpg)
        ids = [] if i == n_ade - 1 and n_ade > 1 else list(
            rng.choice(np.arange(1, len(ADE_CLASSES) + 1), 3, replace=False))
        _save(join(d, "annotations", "training", f"ADE_train_{i:08d}.png"),
              _blobs(rng, h, w, ids, 0))

    # --- cocostuff (label PNGs) and its photos under coco/
    os.makedirs(join(root, "cocostuff"), exist_ok=True)
    with open(join(root, "cocostuff", "cocostuff_classes.txt"), "w") as f:
        f.write("0: unlabeled\n" + "".join(
            f"{i}: {c}\n" for i, c in enumerate(COCOSTUFF_CLASSES)))
    w, h = _size((640, 480), scale)
    for i in range(n_other):
        name = f"{i:012d}"
        _save(join(root, "cocostuff", "train2017", name + ".png"),
              _blobs(rng, h, w, [1, 2, 4] if i else [1, 5], 255))
        _save(join(root, "coco", "train2017", name + ".jpg"),
              _photo(rng, w, h), **jpg)

    # --- mapillary ("P" mode labels)
    d = join(root, "mapillary")
    os.makedirs(d, exist_ok=True)
    with open(join(d, "config_v2.0.json"), "w") as f:
        json.dump({"labels": [{"readable": c} for c in MAPILLARY_CLASSES]},
                  f)
    w, h = _size((800, 600), scale)
    for i in range(n_other):
        _save(join(d, "training", "v2.0", "labels", f"m{i}.png"),
              _blobs(rng, h, w, [0, 1, 3], 2), mode="P")
        _save(join(d, "training", "images", f"m{i}.jpg"), _photo(rng, w, h),
              **jpg)

    # --- paco_lvis (photos under coco/) and pascal_part
    for corpus in ("paco", "pascal_part"):
        w, h = _size((640, 480), scale)
        images, anns = [], []
        for i in range(n_other):
            fname = (f"train2017/paco_{i:06d}.jpg" if corpus == "paco"
                     else f"2008_{i:06d}.jpg")
            path = (join(root, "coco", fname) if corpus == "paco" else
                    join(root, "vlpart", "pascal_part", "VOCdevkit",
                         "VOC2010", "JPEGImages", fname))
            _save(path, _photo(rng, w, h), **jpg)
            images.append({"id": 100 + i, "file_name": fname, "height": h,
                           "width": w})
            for j, (cat, _) in enumerate(PACO_CATEGORIES):
                poly = polygon(rng, w, h)
                seg = ([poly] if (i + j) % 3 else
                       rle_encode(_poly_mask(poly, h, w)))
                anns.append({"id": 1000 * (i + 1) + j, "image_id": 100 + i,
                             "category_id": cat, "segmentation": seg})
        images.append({"id": 999, "file_name": "unused.jpg", "height": h,
                       "width": w})  # no annotations: not a record
        coco = {"images": images, "annotations": anns, "categories": [
            {"id": c, "name": n} for c, n in PACO_CATEGORIES]}
        path = (join(root, "vlpart", "paco", "annotations",
                     "paco_lvis_v1_train.json") if corpus == "paco" else
                join(root, "vlpart", "pascal_part", "train.json"))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(coco, f)

    # --- refer_seg: refcoco / refcocog over COCO photos, refclef
    counts = {"ade20k": n_ade, "refcoco": n_refcoco, "reason_seg": n_reason}
    for ds, split_by, n in (("refcoco", "unc", n_refcoco),
                            ("refcocog", "umd", n_other),
                            ("refclef", "unc", n_other)):
        w, h = _size((640, 480), scale)
        img_dir = (join(root, "refer_seg", "images", "saiapr_tc-12")
                   if ds == "refclef" else
                   join(root, "refer_seg", "images", "mscoco", "images",
                        "train2014"))
        images, anns, refs = [], [], []
        for i in range(n):
            iid = 5000 + 7 * i if ds != "refclef" else 300 + i
            fname = (f"COCO_train2014_{iid:012d}.jpg" if ds != "refclef"
                     else f"{iid}.jpg")
            _save(join(img_dir, fname), _photo(rng, w, h), **jpg)
            images.append({"id": iid, "file_name": fname, "height": h,
                           "width": w})
            ids = []
            for j in range(3):
                aid = iid * 10 + j
                poly = polygon(rng, w, h, off_image=j == 2)
                seg = ([poly, polygon(rng, w, h)] if j == 0 else
                       rle_encode(_poly_mask(poly, h, w)) if j == 1 else
                       [poly])
                anns.append({"id": aid, "image_id": iid,
                             "segmentation": seg})
                ids.append(aid)
            for j, ann_id in enumerate([ids[0], ids[1], [ids[0], ids[2]],
                                        [] if i % 4 == 0 else [ids[1]]]):
                noun = REFER_NOUNS[(i + j) % len(REFER_NOUNS)]
                refs.append({
                    "ref_id": len(refs), "image_id": iid, "ann_id": ann_id,
                    "split": "val" if (i + j) % 5 == 4 else "train",
                    "sentences": [{"sent": f"the {noun} on the left"},
                                  {"sent": f"{noun} {j}"},
                                  {"sent": f"The {noun.upper()} near it"}]})
        d = join(root, "refer_seg", ds)
        os.makedirs(d, exist_ok=True)
        with open(join(d, f"refs({split_by}).p"), "wb") as f:
            pickle.dump(refs, f)
        with open(join(d, "instances.json"), "w") as f:
            json.dump({"images": images, "annotations": anns}, f)

    # --- the index layouts: refer_seg/refcoco, reason_seg, sem_seg/ade20k
    index = {"train": [], "val": []}
    for i in range(n_other * 2):
        w, h = _size((640, 480), scale)
        name = f"refer_{i}.jpg"
        _save(join(root, "images", name), _photo(rng, w, h), **jpg)
        mask = _poly_mask(polygon(rng, w, h), h, w)
        rec = {"image": name, "class_name": REFER_NOUNS[i]}
        if i % 2:
            _save(join(root, "refer_seg", "refcoco", "masks", f"m{i}.png"),
                  mask * 255)
            rec["mask_file"] = f"m{i}.png"
        else:
            rec["sent"] = f"the {REFER_NOUNS[i]} in front"
            rec["mask_rle"] = rle_encode(mask)
        index["train" if i < n_other * 2 - 1 else "val"].append(rec)
    with open(join(root, "refer_seg", "refcoco", "index.pkl"), "wb") as f:
        pickle.dump(index, f)

    index = {"train": [], "val": []}
    for i in range(n_reason):
        w, h = _size(REASON_SIZES[i % len(REASON_SIZES)], scale)
        name = f"reason_{i}.jpg"
        _save(join(root, "images", name), _photo(rng, w, h), **jpg)
        rec = {"image": name,
               "sent": (f"something a person would sit on {i}" if i % 2
                        else REFER_NOUNS[i % len(REFER_NOUNS)]),
               "is_sentence": bool(i % 2),
               "polygons": [polygon(rng, w, h, off_image=i == 3)
                            for _ in range(1 + i % 2)]}
        if i % 4 != 3:
            rec["explanation"] = f"It is the object used for seating {i}."
        index["train" if i < n_reason - 2 or n_reason < 3 else
              "val"].append(rec)
    os.makedirs(join(root, "reason_seg"), exist_ok=True)
    with open(join(root, "reason_seg", "index.pkl"), "wb") as f:
        pickle.dump(index, f)

    index = {"train": [], "val": []}
    for i in range(n_other * 2):
        w, h = _size((683, 512), scale)
        name = f"sem_{i}.jpg"
        _save(join(root, "images", name), _photo(rng, w, h), **jpg)
        _save(join(root, "sem_seg", "ade20k", "labels", f"sem_{i}.png"),
              _blobs(rng, h, w, [3, 5, 7], 0))
        index["train" if i < n_other * 2 - 1 else "val"].append({
            "image": name, "label_file": f"sem_{i}.png",
            "classes": {"floor": 3, "tree": 5, "road": 7, "wall": 1}})
    with open(join(root, "sem_seg", "ade20k", "index.pkl"), "wb") as f:
        pickle.dump(index, f)

    # --- VQA
    records = []
    for i in range(n_vqa):
        name = f"vqa{i}.jpg"
        _save(join(root, "images", name), _photo(rng, *_size((640, 480),
                                                              scale)), **jpg)
        records.append({"image": name,
                        "question": f"What is the person doing {i}?",
                        "answer": f"The person is sitting {i}."})
    with open(join(root, "vqa.pkl"), "wb") as f:
        pickle.dump(records, f)
    return counts
