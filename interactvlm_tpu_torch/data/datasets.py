"""Task datasets and mixture sampling.

Port of ``interactvlm_tpu/data/datasets.py``: ``TemplateFixedRandom``,
``BaseContactDataset``, ``HContactDataset`` (the DAMON and LEMON-HU
sources), ``HContactSceneDataset``, the object datasets
(``OAffordDataset``: PIAD / LEMON point clouds; ``OContactDataset``: PICO
meshes), ``H2DContactDataset``, ``VQADataset``, ``HybridDataset``,
``ValDataset`` and ``build_dataset``. Samples are the JAX package's, array
for array, under the same seeds: the same files, the same numpy
preprocessing and the same python / numpy random draws (template choice,
parts dropout, the mixture's picks, the object match shuffle and the
missing-file retries). A sample is made in two parts: ``plan(idx)`` makes
its draws and file checks, and the function it returns reads the files
and builds it (``ds[idx]`` is ``ds.plan(idx)()``), so a loader can make
every row's draws in row order in one thread and decode anywhere. PNGs
decode through the native decoder
(``runtime/native_image.load_rgb``: the same bytes as PIL's), other images
through PIL. The LISA segmentation datasets (``ReferSegDataset``,
``ReferSegLISADataset``, ``ReasonSegDataset``, ``SemSegDataset``,
``SemSegLISADataset``) decode COCO RLE and fill polygons with the JAX
package's own host code (``rle_decode``, ``fill_polygon``), and read label
PNGs with PIL as they are ("L" or "P" mode).

On-disk layout (the reference ``./data`` tree; ``datagen/recipes.py``
writes it):

  <root>/hcontact_vitruvian_mv2/
      renders/<view_name>.png            fixed canonical body renders
      masks/<sample_id>_<obj>_<view>.png GT contact masks per view
      contact_label_objectwise.pkl       {sample_id: {obj: vert-ids}}
      body_parts_objectwise.pkl          {sample_id: {obj: [part names]}}
      lift_maps.npz                      p2v / bary of the canonical views
  <root>/rendered_points_heatmap/        PIAD / LEMON objects (oafford):
      renders/<id>_<view>.png, heatmaps/<id>_<view>.png, gt/<id>.npz,
      maps/<id>.npz (p2p), index.pkl     {split: [records]}
  <root>/pico_ocontact/                  PICO meshes (ocontact):
      renders/, masks/, gt/<id>.npz (contact, n_verts), maps/<id>.npz
      (p2v, bary), index.pkl
  <root>/hcontact_2d/                    2D contact (h2dcontact):
      masks/<mask>.png, index.pkl
  <root>/vqa.pkl                         VQA records (flat or per split)
  <root>/images/<sample_id>.jpg          the real photos (CLIP input)
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import pickle
import random
import threading
from os.path import join
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from interactvlm_tpu_torch.data.collate import Sample
from interactvlm_tpu_torch.data.conversations import get_conversation_template
from interactvlm_tpu_torch.data.transforms import (
    clip_preprocess,
    sam_label_preprocess,
    sam_preprocess,
    valid_region_mask,
)
from interactvlm_tpu_torch.geometry.views import (
    HUMAN_VIEWS,
    OBJECT_VIEWS,
    ViewSet,
    normalize_cam_params,
)
from interactvlm_tpu_torch.runtime.native_image import load_rgb
from interactvlm_tpu_torch.utils import constants as C


def _load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def build_conversation(
    question: str, answer: str, conv_type: str = "llava_v1"
) -> str:
    conv = get_conversation_template(conv_type)
    conv.append_message(conv.roles[0], question)
    conv.append_message(conv.roles[1], answer)
    return conv.get_prompt()


class TemplateFixedRandom(random.Random):
    """Degenerate dataset rng: always the FIRST option from any
    ``choice``/``sample`` call and no coin flips (``random()`` ~ 1, so
    ``rng.random() < p`` dropouts never fire). Used by the closed-loop
    learning tests on the CONTACT datasets, whose per-sample content is
    index-determined -- there the collapsed calls only pin the
    question/answer templates. NOT suitable for refer/sem/vqa mixtures,
    where ``choice``/``sample`` also select content (sentences, classes,
    annotations) and would collapse training diversity; ``train.py``
    rejects that combination."""

    def choice(self, seq):
        return seq[0]

    def sample(self, seq, k):
        return list(seq[:k])

    def random(self):
        # largest float < 1.0: respects the [0, 1) contract (inherited
        # helpers like choices() compute floor(random() * n)) while still
        # never firing `random() < p` dropouts for any p <= 1 - 2^-53
        return 1.0 - 2.0 ** -53


class BaseContactDataset:
    """Shared loading/conversation helpers
    (reference ``datasets/base_contact_dataset.py``)."""

    def __init__(
        self,
        base_dir: str,
        view_set: ViewSet,
        image_size: int = 1024,
        clip_size: int = 224,
        conv_type: str = "llava_v1",
        token_type: str = "Gen",
        rng: Optional[random.Random] = None,
        num_classes_per_sample: int = 1,
    ):
        self.base_dir = base_dir
        self.view_set = view_set
        self.image_size = image_size
        self.clip_size = clip_size
        self.conv_type = conv_type
        self.token_type = token_type
        self.rng = rng or random.Random(42)
        # seg-style datasets sample up to this many classes per image and
        # emit one conversation and mask per class (reference
        # datasets/dataset.py:196); collate flattens them to rows sharing
        # the image encode (collate.py:_collate_multiconv)
        self.num_classes_per_sample = num_classes_per_sample

    def __getitem__(self, idx: int) -> Sample:
        return self.plan(idx)()

    def plan(self, idx: int) -> Callable[[], Sample]:
        """Sample ``idx``'s random draws from ``self.rng`` and its file
        checks, made now in the order the whole sample makes them, and the
        function that then reads its files and builds the sample. Loaders
        make the plans of a batch's rows in row order in one thread and
        build them on a pool (``train.py:real_batch_iter``): the draws then
        do not depend on which thread builds which row, and a data rank can
        make the plans of rows it does not build."""
        raise NotImplementedError

    # --- image loading -------------------------------------------------
    def load_views(self, paths: Sequence[str]):
        """Render PNGs -> (sam (V,S,S,3), valid (V,H,W), raw (V,H,W,3))."""
        raws = np.stack([load_rgb(p) for p in paths])
        valid = np.stack([valid_region_mask(r) for r in raws])
        sams = []
        resize = None
        for r in raws:
            t, resize = sam_preprocess(r, self.image_size)
            sams.append(t)
        return np.stack(sams), valid, raws, resize

    def load_label_masks(self, paths, valid_regions, binary=True):
        """Mask PNGs -> (V, H, W) float labels with IGNORE outside the
        render's valid region (reference base_contact_dataset.py:134-172)."""
        labels = []
        for i, p in enumerate(paths):
            img = load_rgb(p)[..., 0].astype(np.float32)
            if binary:
                lab = (img >= 128).astype(np.float32)
            else:
                lab = img / 255.0
            lab = np.where(valid_regions[i] > 0, lab, float(C.IGNORE_LABEL))
            labels.append(lab)
        return np.stack(labels)

    def load_clip_image(self, path: str):
        return clip_preprocess(load_rgb(path), self.clip_size)

    def cam_params(self):
        return normalize_cam_params(self.view_set.cam_params())

    # --- conversations --------------------------------------------------
    def human_conversation(
        self, class_name: str, question_type: str = "simple",
        body_parts: Optional[str] = None,
    ):
        """One QA round for human contact; 'parts' template names the body
        parts in the answer (reference hcontact_3d.py:338-343 dropout picks
        between them)."""
        if question_type == "parts" and body_parts:
            q = self.rng.choice(C.HCONTACT_PARTS_QUESTION_LIST)
            a = self.rng.choice(C.HCONTACT_PARTS_ANSWER_LIST).format(
                body_parts=body_parts
            )
        else:
            q = self.rng.choice(C.HCONTACT_QUESTION_LIST)
            a = self.rng.choice(C.HCONTACT_ANSWER_LIST)
        q = q.format(class_name=class_name.lower())
        a = C.substitute_seg_tokens(a, self.token_type)
        return build_conversation(q, a, self.conv_type), q

    def object_conversation(
        self, class_name: str, affordance: Optional[str] = None,
        question_type: str = "simple",
    ):
        """One QA round for an object; the 'afford' template names the
        affordance in the answer."""
        if question_type == "afford" and affordance:
            q = self.rng.choice(C.OAFFORD_AFFORD_QUESTION_LIST)
            a = self.rng.choice(C.OAFFORD_AFFORD_ANSWER_LIST).format(
                affordance=affordance
            )
        else:
            q = self.rng.choice(C.OAFFORD_QUESTION_LIST)
            a = self.rng.choice(C.OAFFORD_ANSWER_LIST)
        q = q.format(class_name=class_name.lower())
        a = C.substitute_seg_tokens(a, self.token_type)
        return build_conversation(q, a, self.conv_type), q


class HContactDataset(BaseContactDataset):
    """DAMON + LEMON-HU 3D human contact (reference
    ``datasets/hcontact_3d.py``: ``init_damon_hcontact`` :37-139 and
    ``init_lemon_hcontact`` :142-195, merged per-source into one dataset).

    The canonical Vitruvian-pose renders are fixed and shared across
    samples (loaded once, hcontact_3d.py:268-271); per-sample GT masks are
    projections of the annotated contact vertices.

    LEMON layout (mirroring the reference's path surgery):
      <root>/lemon/txt_scripts/<split>.txt   image names, one per line;
                                             class = name before first '_'
      <root>/lemon/contact/<stem>.pkl        per-vertex contact array (6890,)
      <root>/lemon/body_parts_<split>.pkl    {stem: [part names]}
      <root>/lemon/masks/<stem>_<view>.png   per-view GT contact masks
    """

    ds_name = "hcontact"

    def __init__(
        self,
        base_dir: str,
        view_type: str = "4MV-Z_Vitru_mv2",
        split: str = "train",
        question_type: str = "parts",
        parts_dropout: float = 0.3,
        train_fraction: float = 1.0,
        num_vertices: int = 6890,
        sources: str = "damon",
        **kw,
    ):
        super().__init__(base_dir, HUMAN_VIEWS[view_type], **kw)
        self.split = split
        self.question_type = question_type
        self.parts_dropout = parts_dropout
        self.num_vertices = num_vertices
        folder = join(base_dir, "hcontact_vitruvian_mv2")
        self.folder = folder
        self.contact_annot = {}
        self.body_parts = {}
        self.lemon_contact = {}
        self.lemon_parts = {}
        # samples: (source, image_name, obj_key, obj_name)
        self.samples: List[tuple] = []

        if "damon" in sources:
            self.contact_annot = _load_pickle(
                join(folder, "contact_label_objectwise.pkl")
            )
            parts_file = join(folder, "body_parts_objectwise.pkl")
            self.body_parts = (
                _load_pickle(parts_file) if os.path.exists(parts_file)
                else {}
            )
            for image_name, objs in sorted(self.contact_annot.items()):
                for obj_name in sorted(objs):
                    if obj_name == "foot_ground":
                        # rename (hcontact_3d.py:92-93)
                        obj_name_out = "scene"
                    else:
                        obj_name_out = obj_name
                    self.samples.append(
                        ("damon", image_name, obj_name, obj_name_out)
                    )

            if split == "train" and train_fraction < 1.0:
                # deterministic subsample, seed 42 (hcontact_3d.py:104-126);
                # applies to DAMON only, like the reference
                rng = np.random.default_rng(42)
                n = max(1, int(len(self.samples) * train_fraction))
                idx = rng.choice(len(self.samples), size=n, replace=False)
                self.samples = [self.samples[i] for i in sorted(idx)]

        if "lemon" in sources:
            # LEMON-HU merge (reference init_lemon_hcontact :142-195):
            # per-image per-vertex contact; zero-contact images skipped
            lsplit = split if split != "test" else "val"
            img_list = open(
                join(base_dir, "lemon", "txt_scripts", f"{lsplit}.txt")
            ).read().splitlines()
            parts_file = join(base_dir, "lemon", f"body_parts_{lsplit}.pkl")
            self.lemon_parts = (
                _load_pickle(parts_file) if os.path.exists(parts_file)
                else {}
            )
            for image_name in img_list:
                stem = os.path.splitext(os.path.basename(image_name))[0]
                contact = np.asarray(
                    _load_pickle(
                        join(base_dir, "lemon", "contact", f"{stem}.pkl")
                    )
                ).reshape(-1)
                if contact.nonzero()[0].size == 0:
                    continue  # reference warns and skips (:167-169)
                self.lemon_contact[stem] = contact
                obj_name = os.path.basename(image_name).split("_")[0]
                self.samples.append(("lemon", image_name, stem, obj_name))

        # fixed canonical renders, shared across samples
        render_paths = [
            join(folder, "renders", f"{v}.png") for v in self.view_set.names
        ]
        self.sam_images, self.valid_regions, _, self.resize = self.load_views(
            render_paths
        )

    def __len__(self):
        return len(self.samples)

    def plan(self, idx: int) -> Callable[[], Sample]:
        source, image_name, obj_key, obj_name = self.samples[idx]
        stem = os.path.splitext(os.path.basename(image_name))[0]
        gt = np.zeros(self.num_vertices, np.float32)
        if source == "damon":
            contact_ids = np.asarray(
                self.contact_annot[image_name][obj_key]
            ).reshape(-1)
            gt[contact_ids[contact_ids < self.num_vertices]] = 1.0
            mask_paths = [
                join(self.folder, "masks", f"{stem}_{obj_key}_{v}.png")
                for v in self.view_set.names
            ]
            parts = None
            if image_name in self.body_parts and obj_key in self.body_parts[
                image_name
            ]:
                parts = ", ".join(self.body_parts[image_name][obj_key])
            image_path = join(self.base_dir, "images", image_name)
        else:  # lemon
            contact = self.lemon_contact[obj_key][: self.num_vertices]
            gt[: contact.size] = (contact > 0).astype(np.float32)
            mask_paths = [
                join(self.base_dir, "lemon", "masks", f"{stem}_{v}.png")
                for v in self.view_set.names
            ]
            parts = (
                ", ".join(self.lemon_parts[stem])
                if stem in self.lemon_parts else None
            )
            image_path = join(self.base_dir, image_name)

        # body-part dropout: with prob p fall back to the simple template
        # (hcontact_3d.py:338-343, FIX.md:22-27)
        qtype = self.question_type
        if qtype == "parts" and self.rng.random() < self.parts_dropout:
            qtype = "simple"
        conv, q = self.human_conversation(obj_name, qtype, parts)

        def build() -> Sample:
            masks = self.load_label_masks(mask_paths, self.valid_regions)
            return Sample(
                image_path=image_path,
                sam_images=self.sam_images,
                image_clip=self.load_clip_image(image_path),
                conversations=[conv],
                masks=masks,
                label=masks[0],
                gt_contact_3d=gt,
                cam_params=self.cam_params(),
                resize=self.resize,
                questions=[q],
                sampled_classes=[obj_name],
                ds_name=self.ds_name,
                mask_paths=mask_paths,
            )

        return build


class OAffordDataset(BaseContactDataset):
    """PIAD/LEMON object point-cloud affordance
    (reference ``datasets/ocontact_3d.py:76-337``): per-sample object
    renders + heatmap labels + pixel->point maps."""

    ds_name = "oafford"

    def __init__(
        self,
        base_dir: str,
        view_type: str = "4MV-Z_HM",
        split: str = "train",
        num_points: int = 2048,
        question_type: str = "simple",
        object_ranking: str = "openshape",
        **kw,
    ):
        super().__init__(base_dir, OBJECT_VIEWS[view_type], **kw)
        self.split = split
        self.num_points = num_points
        self.question_type = question_type
        self.object_ranking = object_ranking
        self.folder = join(base_dir, "rendered_points_heatmap")
        index = _load_pickle(join(self.folder, "index.pkl"))
        # index: list of dicts {image, object_id, class_name, affordance}
        self.samples = index[split]

    def __len__(self):
        return len(self.samples)

    def _paths(self, object_id: str, kind: str):
        return [
            join(self.folder, kind, f"{object_id}_{v}.png")
            for v in self.view_set.names
        ]

    def plan(self, idx: int) -> Callable[[], Sample]:
        return _retry_missing(self, idx)

    def _candidates(self, rec) -> List[str]:
        """Object candidates for one image sample.

        Train mode uses the OpenShape image->mesh retrieval ranking with up
        to 5 retries over ranked matches, skipping zero-contact or missing
        entries (reference ocontact_3d.py:179-219 ``object_match``); test
        mode is the 1:1 assignment (:123-131)."""
        if self.split == "train" and rec.get("object_matches"):
            cands = list(rec["object_matches"])[:5]
            if self.object_ranking == "random":
                self.rng.shuffle(cands)
            return cands
        return [rec["object_id"]]

    def _plan(self, idx: int) -> Callable[[], Sample]:
        rec = self.samples[idx]
        oid = gt = None
        for cand in self._candidates(rec):
            gt_path = join(self.folder, "gt", f"{cand}.npz")
            if not os.path.exists(gt_path):
                continue
            g = np.load(gt_path)["affordance"].astype(np.float32)
            if self.split == "train" and np.count_nonzero(g) == 0:
                continue  # zero-contact retry (ocontact_3d.py:193-195)
            if all(os.path.exists(p) for p in self._paths(cand, "renders")):
                oid, gt = cand, g
                break
        if oid is None:
            raise FileNotFoundError(
                f"no valid object match for {rec.get('image')}"
            )
        heat_paths = self._paths(oid, "heatmaps")
        _require_files(heat_paths)
        gt = gt[: self.num_points]
        if gt.size < self.num_points:
            gt = np.pad(gt, (0, self.num_points - gt.size))

        # per-sample pixel->point map (reference derives the p2pmap path
        # from the mask path, model/components.py:309)
        maps_path = join(self.folder, "maps", f"{oid}.npz")
        has_maps = os.path.exists(maps_path)

        conv, q = self.object_conversation(
            rec["class_name"], rec.get("affordance"), self.question_type
        )
        image_path = join(self.base_dir, "images", rec["image"])
        _require_files([image_path])

        def build() -> Sample:
            sam_images, valid, _, resize = self.load_views(
                self._paths(oid, "renders")
            )
            heatmaps = self.load_label_masks(heat_paths, valid, binary=False)
            obj_p2p = (np.load(maps_path)["p2p"].astype(np.int32)
                       if has_maps else None)
            return Sample(
                image_path=image_path,
                sam_images=sam_images,
                image_clip=self.load_clip_image(image_path),
                conversations=[conv],
                masks=heatmaps,
                label=heatmaps[0],
                gt_contact_3d=gt,
                cam_params=self.cam_params(),
                resize=resize,
                questions=[q],
                sampled_classes=[rec["class_name"]],
                ds_name=self.ds_name,
                mask_paths=self._paths(oid, "mask"),
                obj_p2p=obj_p2p,
            )

        return build


def _require_files(paths: Sequence[str]) -> None:
    """Raise ``FileNotFoundError`` (as reading it would) for the first of
    ``paths`` that is missing: a plan's check of the files its build
    reads, where a missing one makes the dataset draw another index."""
    for path in paths:
        if not os.path.exists(path):
            raise FileNotFoundError(path)


def _retry_missing(ds, idx: int) -> Callable[[], Sample]:
    """``ds._plan(idx)``, and on a missing file up to four more draws of
    another index from the dataset's rng (the reference's skip-and-retry,
    ocontact_3d.py:179-222)."""
    for _ in range(5):
        try:
            return ds._plan(idx)
        except FileNotFoundError as e:
            last = e
            idx = ds.rng.randrange(len(ds.samples))
    raise last


class VQADataset(BaseContactDataset):
    """LLaVA-instruct + GPT-4o HOI-VQA
    (reference ``datasets/vqa_dataset.py``): plain QA, empty masks.

    A row carries one zero SAM image and IGNORE masks, both
    ``image_size`` square, so that it stacks with the contact rows of a
    mixture at any size (the JAX package's masks are 64^2 at every size,
    which its collate can stack only at image_size 64; ROADMAP Queue C)."""

    ds_name = "vqa"

    def __init__(self, base_dir: str, annotation_file: str = "vqa.pkl",
                 view_type: str = "4MV-Z_Vitru_mv2", split: str = "train",
                 **kw):
        super().__init__(base_dir, HUMAN_VIEWS[view_type], **kw)
        self.split = split
        records = _load_pickle(join(base_dir, annotation_file))
        # vqa.pkl is either a flat record list (the reference's VQA source,
        # llava_v1_5_mix665k, is train-only: datasets/vqa_dataset.py:64-85)
        # or {split: [records]} like the other index.pkl layouts.
        self.records = records[split] if isinstance(records, dict) else records

    def __len__(self):
        return len(self.records)

    def plan(self, idx: int) -> Callable[[], Sample]:
        return lambda: self._build(idx)  # no draws

    def _build(self, idx: int) -> Sample:
        rec = self.records[idx]
        img_path = join(self.base_dir, "images", rec["image"])
        conv = build_conversation(
            C.DEFAULT_IMAGE_TOKEN + "\n" + rec["question"],
            rec["answer"], self.conv_type,
        )
        S = self.image_size
        return Sample(
            image_path=img_path,
            sam_images=np.zeros((1, S, S, 3), np.float32),
            image_clip=self.load_clip_image(img_path),
            conversations=[conv],
            masks=np.full((1, S, S), float(C.IGNORE_LABEL), np.float32),
            label=np.zeros((S, S), np.float32),
            gt_contact_3d=np.zeros(1, np.float32),
            cam_params=np.zeros((1, 5), np.float32),
            resize=(S, S),
            questions=[rec["question"]],
            sampled_classes=[],
            ds_name=self.ds_name,
            mask_paths=[],
        )


class HybridDataset:
    """Mixture-of-datasets sampler (reference ``datasets/dataset.py:181-378``):
    each index draws a dataset by normalized sample rate, then a uniform
    random element; ``len`` is the synthetic epoch length
    samples_per_epoch = bs * grad_acc * steps * world_size
    (train.py:332)."""

    def __init__(
        self,
        datasets: Sequence,
        sample_rates: Sequence[float],
        samples_per_epoch: int,
        seed: int = 42,
    ):
        assert len(datasets) == len(sample_rates) > 0
        self.datasets = list(datasets)
        rates = np.asarray(sample_rates, np.float64)
        self.rates = rates / rates.sum()
        self.samples_per_epoch = samples_per_epoch
        self.rng = np.random.default_rng(seed)
        # draws serialize under a lock so thread-pool loaders
        # (runtime/prefetch.ParallelSampler) can fetch samples in
        # parallel: np.random.Generator is not thread-safe, and only the
        # (cheap) pick needs ordering -- the heavy per-sample IO runs
        # outside the lock
        self._lock = threading.Lock()

    def __len__(self):
        return self.samples_per_epoch

    def pick(self):
        """Thread-safe (dataset, element-index) draw."""
        with self._lock:
            ds = self.datasets[
                int(self.rng.choice(len(self.datasets), p=self.rates))
            ]
            return ds, int(self.rng.integers(len(ds)))

    def plan(self) -> Callable[[], Sample]:
        """The next row's plan: the mixture's pick, then the picked
        element's own draws (``BaseContactDataset.plan``)."""
        ds, j = self.pick()
        return ds.plan(j)

    def __getitem__(self, idx: int) -> Sample:
        return self.plan()()


class HContactSceneDataset(HContactDataset):
    """RICH scene contact (reference ``datasets/hcontactScene_3d.py``):
    same canonical-body machinery as DAMON, with the object class fixed to
    'scene' (hcontactScene_3d.py:53)."""

    ds_name = "hcontact_scene"

    def __init__(self, base_dir: str, **kw):
        kw.setdefault("question_type", "simple")
        super().__init__(base_dir, **kw)
        # every sample queries the scene
        self.samples = [
            (src, img, obj, "scene") for (src, img, obj, _) in self.samples
        ]


class OContactDataset(BaseContactDataset):
    """PICO object-mesh contact (reference ``datasets/ocontact_3d.py:
    380-527``): per-sample low-poly mesh renders with binary contact masks
    and per-sample pixel->vertex maps (variable vertex counts, padded to
    ``max_vertices`` for fixed-shape batching)."""

    ds_name = "ocontact"

    def __init__(
        self,
        base_dir: str,
        view_type: str = "4MV-Z_HM_BM",
        split: str = "train",
        max_vertices: int = 8192,
        question_type: str = "simple",
        **kw,
    ):
        super().__init__(base_dir, OBJECT_VIEWS[view_type], **kw)
        self.split = split
        self.max_vertices = max_vertices
        self.question_type = question_type
        self.folder = join(base_dir, "pico_ocontact")
        index = _load_pickle(join(self.folder, "index.pkl"))
        self.samples = index[split]

    def __len__(self):
        return len(self.samples)

    def plan(self, idx: int) -> Callable[[], Sample]:
        return _retry_missing(self, idx)

    def _plan(self, idx: int) -> Callable[[], Sample]:
        rec = self.samples[idx]
        oid = rec["object_id"]
        paths = [
            join(self.folder, "renders", f"{oid}_{v}.png")
            for v in self.view_set.names
        ]
        mask_paths = [
            join(self.folder, "masks", f"{oid}_{v}.png")
            for v in self.view_set.names
        ]
        gt_path = join(self.folder, "gt", f"{oid}.npz")
        _require_files(paths + mask_paths + [gt_path])
        # per-sample pixel->vertex + barycentric maps
        # (reference model/components.py:363-377 loads p2vmap npz per sample)
        maps_path = join(self.folder, "maps", f"{oid}.npz")
        has_maps = os.path.exists(maps_path)

        conv, q = self.object_conversation(
            rec["class_name"], question_type=self.question_type
        )
        image_path = join(self.base_dir, "images", rec["image"])
        _require_files([image_path])

        def build() -> Sample:
            sam_images, valid, _, resize = self.load_views(paths)
            masks = self.load_label_masks(mask_paths, valid)
            gt_file = np.load(gt_path)
            contact = gt_file["contact"].astype(np.float32)
            n_verts = int(gt_file.get("n_verts", contact.size))
            gt = np.zeros(self.max_vertices, np.float32)
            gt[: min(contact.size, self.max_vertices)] = contact[
                : self.max_vertices
            ]
            obj_p2v = obj_bary = None
            if has_maps:
                m = np.load(maps_path)
                obj_p2v = m["p2v"].astype(np.int32)
                obj_bary = m["bary"].astype(np.float32)
            return Sample(
                image_path=image_path,
                sam_images=sam_images,
                image_clip=self.load_clip_image(image_path),
                conversations=[conv],
                masks=masks,
                label=masks[0],
                gt_contact_3d=gt,
                cam_params=self.cam_params(),
                resize=resize,
                questions=[q],
                sampled_classes=[rec["class_name"]],
                ds_name=self.ds_name,
                mask_paths=mask_paths,
                obj_p2v=obj_p2v,
                obj_bary=obj_bary,
                num_valid_verts=n_verts,
            )

        return build


class H2DContactDataset(BaseContactDataset):
    """DAMON contact projected onto the *input image* -- 2D referring
    segmentation, single view (reference ``datasets/hcontact_2d.py``).
    The mask PNG is read as PIL's grey ("L") conversion, as the JAX
    package reads it."""

    ds_name = "h2dcontact"

    def __init__(self, base_dir: str, split: str = "train",
                 view_type: str = "4MV-Z_Vitru_mv2", **kw):
        super().__init__(base_dir, HUMAN_VIEWS[view_type], **kw)
        self.folder = join(base_dir, "hcontact_2d")
        index = _load_pickle(join(self.folder, "index.pkl"))
        self.samples = index[split]

    def __len__(self):
        return len(self.samples)

    def plan(self, idx: int) -> Callable[[], Sample]:
        conv, q = self.human_conversation(self.samples[idx]["class_name"],
                                          "simple")
        return lambda: self._build(idx, conv, q)

    def _build(self, idx: int, conv, q) -> Sample:
        from PIL import Image

        rec = self.samples[idx]
        img_path = join(self.base_dir, "images", rec["image"])
        sam_img, resize = sam_preprocess(load_rgb(img_path), self.image_size)
        mask_path = join(self.folder, "masks", rec["mask"])
        mask = (np.asarray(Image.open(mask_path).convert("L")) >= 128
                ).astype(np.float32)
        return Sample(
            image_path=img_path,
            sam_images=sam_img[None],
            image_clip=self.load_clip_image(img_path),
            conversations=[conv],
            masks=sam_label_preprocess(mask, self.image_size)[None],
            label=mask,
            gt_contact_3d=np.zeros(1, np.float32),
            cam_params=np.zeros((1, 5), np.float32),
            resize=resize,
            questions=[q],
            sampled_classes=[rec["class_name"]],
            ds_name=self.ds_name,
            mask_paths=[mask_path],
        )


class ValDataset:
    """Validation wrapper: a fixed, ordered pass over one task dataset
    (reference ``datasets/dataset.py:381-592`` semantics -- deterministic
    order AND deterministic prompts, inference flag set).

    The underlying dataset's question/answer templates draw from its rng;
    re-seeding per index makes every validation pass identical, so epoch
    metrics are comparable (reference val datasets use fixed sentences)."""

    def __init__(self, dataset, seed: int = 42):
        self.dataset = dataset
        self.seed = seed
        # validation never drops the parts template
        if hasattr(dataset, "parts_dropout"):
            dataset.parts_dropout = 0.0

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx: int) -> Sample:
        # preserve the rng class: a TemplateFixedRandom dataset keeps
        # fixed templates through validation re-seeding
        self.dataset.rng = type(self.dataset.rng)(self.seed + idx)
        s = self.dataset[idx]
        return dataclasses.replace(s, inference=True)


def rle_decode(rle: Dict) -> np.ndarray:
    """Decode a COCO RLE mask, compressed (the LEB128-style string) or
    uncompressed (a counts list), without pycocotools (reference
    datasets/dataset.py:541-552). Column-major, as pycocotools gives it."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        if isinstance(counts, str):
            counts = counts.encode()
        decoded, i = [], 0
        while i < len(counts):
            x, k, more = 0, 0, True
            while more:
                c = counts[i] - 48
                x |= (c & 0x1F) << (5 * k)
                more = bool(c & 0x20)
                i += 1
                k += 1
            if x & (1 << (5 * k - 1)):
                x |= -1 << (5 * k)
            if len(decoded) > 2:
                x += decoded[-2]
            decoded.append(x)
        counts = decoded
    mask = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in counts:
        if val:
            mask[pos : pos + c] = 1
        pos += c
        val ^= 1
    return mask.reshape(w, h).T


def fill_polygon(points, height: int, width: int) -> np.ndarray:
    """Scanline polygon fill (the host-side stand-in for cv2's fillPoly in
    the reference ReasonSeg mask code, utils/data_processing.py):
    sampled at row centres ``y + 0.5``, the half-open crossing rule, and
    pixels ``ceil(a - 0.5)`` to ``ceil(b - 0.5)`` of each span."""
    pts = np.asarray(points, np.float64).reshape(-1, 2)
    mask = np.zeros((height, width), np.uint8)
    if len(pts) < 3:
        return mask
    ys = np.arange(height) + 0.5
    x0 = pts[:, 0]
    y0 = pts[:, 1]
    x1 = np.roll(x0, -1)
    y1 = np.roll(y0, -1)
    for yi, y in enumerate(ys):
        crosses = ((y0 <= y) & (y1 > y)) | ((y1 <= y) & (y0 > y))
        if not crosses.any():
            continue
        xs = x0[crosses] + (y - y0[crosses]) / (
            y1[crosses] - y0[crosses]
        ) * (x1[crosses] - x0[crosses])
        xs = np.sort(xs)
        for a, b in zip(xs[0::2], xs[1::2]):
            lo = max(int(np.ceil(a - 0.5)), 0)
            hi = min(int(np.ceil(b - 0.5)), width)
            if hi > lo:
                mask[yi, lo:hi] = 1
    return mask


def _coco_ann_to_mask(ann: Dict, h: int, w: int) -> np.ndarray:
    """COCO annotation -> binary mask without pycocotools (annToMask): a
    dict segmentation through ``rle_decode``, a polygon list as the union
    of ``fill_polygon``s."""
    seg = ann["segmentation"]
    if isinstance(seg, dict):
        return rle_decode(seg).astype(np.float32)
    mask = np.zeros((h, w), np.float32)
    for poly in seg:
        mask = np.maximum(mask, fill_polygon(poly, h, w))
    return mask


def _read_label_png(path: str) -> np.ndarray:
    """A label PNG as PIL reads it, unconverted ("L" or "P" ids)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


class _SegDataset(BaseContactDataset):
    """The LISA segmentation datasets' shared plan: the draws of the
    sampled items, then per item a question and an answer; the build
    reads the photo and makes the single-view sample with one
    conversation and mask per item."""

    def _pick(self, items: Sequence) -> list:
        """Up to ``num_classes_per_sample`` of ``items``: ``sample`` when
        more than one, else one ``choice``."""
        n = min(self.num_classes_per_sample, len(items))
        return self.rng.sample(items, n) if n > 1 else [
            self.rng.choice(items)]

    def _short_qa(self, name: str):
        q = self.rng.choice(C.SHORT_QUESTION_LIST).format(
            class_name=name.lower())
        a = self.rng.choice(C.ANSWER_LIST)
        return build_conversation(q, a, self.conv_type), q

    def _sample(self, img_path: str, img: np.ndarray, convs, questions,
                names, masks, label) -> Sample:
        sam_img, resize = sam_preprocess(img, self.image_size)
        return Sample(
            image_path=img_path,
            sam_images=sam_img[None],
            image_clip=clip_preprocess(img, self.clip_size),
            conversations=list(convs),
            masks=np.stack([sam_label_preprocess(m, self.image_size)
                            for m in masks]),
            label=label,
            gt_contact_3d=np.zeros(1, np.float32),
            cam_params=np.zeros((1, 5), np.float32),
            resize=resize,
            questions=list(questions),
            sampled_classes=list(names),
            ds_name=self.ds_name,
            mask_paths=[],
        )


class ReferSegDataset(_SegDataset):
    """LISA-legacy referring segmentation (refclef/refcoco/+/g; reference
    ``datasets/refer_seg_dataset.py``) over an index of records carrying
    an RLE mask or a mask PNG.

    index.pkl: {split: [{image, class_name/sent, mask_rle | mask_file}]}
    """

    ds_name = "refer_seg"

    def __init__(self, base_dir: str, dataset: str = "refcoco",
                 split: str = "train",
                 view_type: str = "4MV-Z_Vitru_mv2", **kw):
        super().__init__(base_dir, HUMAN_VIEWS[view_type], **kw)
        self.folder = join(base_dir, "refer_seg", dataset)
        self.samples = _load_pickle(join(self.folder, "index.pkl"))[split]

    def __len__(self):
        return len(self.samples)

    def plan(self, idx: int) -> Callable[[], Sample]:
        rec = self.samples[idx]
        sent = rec.get("sent") or rec["class_name"]
        conv, q = self._short_qa(sent)

        def build() -> Sample:
            img_path = join(self.base_dir, "images", rec["image"])
            if "mask_rle" in rec:
                mask = rle_decode(rec["mask_rle"]).astype(np.float32)
            else:
                from PIL import Image

                with Image.open(join(self.folder, "masks",
                                     rec["mask_file"])) as im:
                    mask = (np.asarray(im.convert("L")) >= 128).astype(
                        np.float32)
            return self._sample(img_path, load_rgb(img_path), [conv], [q],
                                [sent], [mask], mask)

        return build


class ReferSegLISADataset(_SegDataset):
    """Referring segmentation over the REAL REFER corpora layout
    (reference ``datasets/refer_seg_dataset.py`` + the REFER/G_REFER API):
    ``refer_seg/{ds}/refs({splitBy}).p`` pickles + ``instances.json``
    COCO-style annotations; images under ``images/saiapr_tc-12`` (refclef)
    or ``images/mscoco/images/train2014`` (refcoco/+/g).

    splitBy follows the reference: umd for refcocog, unc otherwise
    (refer_seg_dataset.py:57-61). grefcoco refs carry ann_id LISTS whose
    masks are unioned; empty lists (no-target) give a zero mask. Records
    are the images in sorted id order.
    """

    ds_name = "refer_seg"

    def __init__(self, base_dir: str, dataset: str = "refcoco",
                 split: str = "train",
                 view_type: str = "4MV-Z_Vitru_mv2", **kw):
        super().__init__(base_dir, HUMAN_VIEWS[view_type], **kw)
        self.dataset = dataset
        data_dir = join(base_dir, "refer_seg")
        split_by = "umd" if dataset == "refcocog" else "unc"
        refs = _load_pickle(join(data_dir, dataset, f"refs({split_by}).p"))
        with open(join(data_dir, dataset, "instances.json")) as f:
            inst = json.load(f)
        self.anns = {a["id"]: a for a in inst["annotations"]}
        img_info = {im["id"]: im for im in inst["images"]}
        if dataset == "refclef":
            img_root = join(data_dir, "images", "saiapr_tc-12")
        else:
            img_root = join(data_dir, "images", "mscoco", "images",
                            "train2014")
        self.img2refs: Dict = {}
        for ref in refs:
            if ref.get("split", "train") != split:
                continue
            self.img2refs.setdefault(ref["image_id"], []).append(ref)
        self.records = [
            (join(img_root, img_info[i]["file_name"]),
             img_info[i]["height"], img_info[i]["width"], i)
            for i in sorted(self.img2refs) if i in img_info
        ]

    def __len__(self):
        return len(self.records)

    def _ref_mask(self, ref, h: int, w: int) -> np.ndarray:
        ann_ids = ref["ann_id"]
        if not isinstance(ann_ids, list):  # REFER; G_REFER uses lists
            ann_ids = [ann_ids]
        mask = np.zeros((h, w), np.float32)
        for aid in ann_ids:  # empty (grefcoco no-target) -> zero mask
            if aid in self.anns and self.anns[aid].get("segmentation"):
                mask = np.maximum(mask,
                                  _coco_ann_to_mask(self.anns[aid], h, w))
        return mask

    def plan(self, idx: int) -> Callable[[], Sample]:
        img_path, h, w, image_id = self.records[idx]
        picked, sents, convs, questions = [], [], [], []
        for ref in self._pick(self.img2refs[image_id]):
            sent = self.rng.choice(ref["sentences"])["sent"]
            conv, q = self._short_qa(sent)
            picked.append(ref)
            sents.append(sent)
            convs.append(conv)
            questions.append(q)

        def build() -> Sample:
            masks = [self._ref_mask(ref, h, w) for ref in picked]
            return self._sample(img_path, load_rgb(img_path), convs,
                                questions, sents, masks, masks[0])

        return build


class ReasonSegDataset(_SegDataset):
    """LISA-legacy reasoning segmentation (reference
    ``datasets/reason_seg_dataset.py``): polygon annotations, long
    explanatory questions and the explanatory-answer mix.

    index.pkl: {split: [{image, sent, polygons: [[x,y,...], ...],
    is_sentence: bool, explanation?: str}]}
    """

    ds_name = "reason_seg"

    def __init__(self, base_dir: str, split: str = "train",
                 view_type: str = "4MV-Z_Vitru_mv2",
                 explanatory: float = 0.1, **kw):
        super().__init__(base_dir, HUMAN_VIEWS[view_type], **kw)
        self.folder = join(base_dir, "reason_seg")
        self.explanatory = explanatory
        self.samples = _load_pickle(join(self.folder, "index.pkl"))[split]

    def __len__(self):
        return len(self.samples)

    def plan(self, idx: int) -> Callable[[], Sample]:
        rec = self.samples[idx]
        sent = rec["sent"]
        if rec.get("is_sentence"):
            q = self.rng.choice(C.LONG_QUESTION_LIST).format(sent=sent)
        else:
            q = self.rng.choice(C.SHORT_QUESTION_LIST).format(
                class_name=sent.lower())
        a = self.rng.choice(C.ANSWER_LIST)
        # explanatory-QA mix (reference reason_seg_dataset.py:136-180):
        # 0 = [SEG]-only, 1 = [SEG] + explanation text (the question asks
        # for it), 2 = the explanation alone, without a seg token
        explanation = rec.get("explanation")
        if self.explanatory != -1 and explanation:
            if self.rng.random() < self.explanatory:
                choice = 2
            else:
                choice = self.rng.randint(0, 1)
            if choice == 1:
                q = q + " " + self.rng.choice(C.EXPLANATORY_QUESTION_LIST)
                a = a + " " + explanation
            elif choice == 2:
                a = explanation
        conv = build_conversation(q, a, self.conv_type)

        def build() -> Sample:
            img_path = join(self.base_dir, "images", rec["image"])
            img = load_rgb(img_path)
            H, W = img.shape[:2]
            mask = np.zeros((H, W), np.float32)
            for poly in rec["polygons"]:
                mask = np.maximum(mask, fill_polygon(poly, H, W))
            return self._sample(img_path, img, [conv], [q], [sent], [mask],
                                mask)

        return build


class SemSegDataset(_SegDataset):
    """LISA-legacy semantic segmentation (ADE20K/COCO-Stuff-style;
    reference ``datasets/sem_seg_dataset.py``) over an index of records
    with a label PNG of class ids.

    index.pkl: {split: [{image, label_file, classes: {name: class_id}}]}
    """

    ds_name = "sem_seg"

    def __init__(self, base_dir: str, dataset: str = "ade20k",
                 split: str = "train",
                 view_type: str = "4MV-Z_Vitru_mv2", **kw):
        super().__init__(base_dir, HUMAN_VIEWS[view_type], **kw)
        self.folder = join(base_dir, "sem_seg", dataset)
        self.samples = _load_pickle(join(self.folder, "index.pkl"))[split]

    def __len__(self):
        return len(self.samples)

    def plan(self, idx: int) -> Callable[[], Sample]:
        rec = self.samples[idx]
        names = self._pick(sorted(rec["classes"]))
        qa = [self._short_qa(name) for name in names]

        def build() -> Sample:
            img_path = join(self.base_dir, "images", rec["image"])
            label_ids = _read_label_png(
                join(self.folder, "labels", rec["label_file"]))
            masks = [(label_ids == rec["classes"][name]).astype(np.float32)
                     for name in names]
            return self._sample(img_path, load_rgb(img_path),
                                [c for c, _ in qa], [q for _, q in qa],
                                names, masks, masks[0])

        return build


class SemSegLISADataset(_SegDataset):
    """LISA-legacy semantic segmentation over the REAL dataset layouts
    (reference ``datasets/sem_seg_dataset.py``): ade20k / cocostuff /
    mapillary id-map PNGs and the paco_lvis / pascal_part COCO-style part
    annotations, with the reference's label remaps and class naming.

    An item whose remapped label map is all-ignore falls through to the
    next (bounded by one pass over the dataset; the reference restarts at
    item 0, :263-265). The plan decodes the label PNGs it scans, since the
    classes it draws from are the ones present; the photo is read by the
    build.
    """

    ds_name = "sem_seg"
    IGNORE = 255

    def __init__(self, base_dir: str, dataset: str = "ade20k",
                 view_type: str = "4MV-Z_Vitru_mv2", split: str = "train",
                 **kw):
        super().__init__(base_dir, HUMAN_VIEWS[view_type], **kw)
        # the reference inits hardcode the training splits of these corpora
        # (sem_seg_dataset.py:39-124): the split is accepted for
        # build_dataset's uniformity and selects the same records
        self.split = split
        self.dataset = dataset
        if dataset == "ade20k":
            # init_ade20k (:39-67): class json + paired images/training <->
            # annotations/training PNGs
            with open(join(base_dir, "ade20k", "ade20k_classes.json")) as f:
                self.classes = json.load(f)
            img_dir = join(base_dir, "ade20k", "images", "training")
            self.images = sorted(
                join(img_dir, x) for x in os.listdir(img_dir)
                if x.endswith(".jpg"))
            self.labels = [
                x.replace(".jpg", ".png").replace("images", "annotations")
                for x in self.images]
        elif dataset == "cocostuff":
            # init_cocostuff (:69-86): "id: name" txt (first line skipped),
            # label PNGs under cocostuff/train2017, images under coco/
            with open(join(base_dir, "cocostuff",
                           "cocostuff_classes.txt")) as f:
                self.classes = [line.strip().split(": ")[-1]
                                for line in f.readlines()[1:]]
            self.labels = sorted(glob.glob(
                join(base_dir, "cocostuff", "train2017", "*.png")))
            self.images = [
                x.replace(".png", ".jpg").replace("cocostuff", "coco")
                for x in self.labels]
            # multi-word "-" classes are unsegmentable -> ignored (:254-256)
            self.coco_ignore_ids = {
                i for i, c in enumerate(self.classes) if "-" in c}
        elif dataset == "mapillary":
            # init_mapillary (:20-36): config_v2.0.json readable names
            with open(join(base_dir, "mapillary", "config_v2.0.json")) as f:
                self.classes = [x["readable"].lower()
                                for x in json.load(f)["labels"]]
            self.labels = sorted(glob.glob(join(
                base_dir, "mapillary", "training", "v2.0", "labels",
                "*.png")))
            self.images = [
                x.replace(".png", ".jpg").replace("v2.0/labels", "images")
                for x in self.labels]
        elif dataset in ("paco_lvis", "pascal_part"):
            # init_paco_lvis (:88-110) / init_pascal_part (:113-124):
            # COCO-style json; "obj:part" names with "_(...)" stripped
            if dataset == "paco_lvis":
                ann_json = join(base_dir, "vlpart", "paco", "annotations",
                                "paco_lvis_v1_train.json")
            else:
                ann_json = join(base_dir, "vlpart", "pascal_part",
                                "train.json")
            with open(ann_json) as f:
                coco = json.load(f)
            self.class_map = {}
            for cat in coco["categories"]:
                parts = cat["name"].strip().split(":")
                if len(parts) == 1:
                    self.class_map[cat["id"]] = parts[0].split("_(")[0]
                else:
                    obj, part = parts
                    self.class_map[cat["id"]] = (
                        obj.split("_(")[0], part.split("_(")[0])
            self.img_info = {im["id"]: im for im in coco["images"]}
            self.img_anns: Dict = {}
            for ann in coco["annotations"]:
                self.img_anns.setdefault(ann["image_id"], []).append(ann)
            self.img_ids = [i for i in self.img_info if self.img_anns.get(i)]
        else:
            raise ValueError(f"unknown sem_seg dataset {dataset!r}")

    def __len__(self):
        if self.dataset in ("paco_lvis", "pascal_part"):
            return len(self.img_ids)
        return len(self.images)

    def _remap(self, label: np.ndarray) -> np.ndarray:
        lab = label.astype(np.int32)
        if self.dataset == "ade20k":
            # 0 = unlabeled -> ignore; ids shift down by 1 (:245-248)
            lab[lab == 0] = self.IGNORE + 1
            lab = lab - 1
            lab[lab == 254] = self.IGNORE
        elif self.dataset == "cocostuff":
            for i in self.coco_ignore_ids:
                lab[lab == i] = self.IGNORE
        return lab

    def plan(self, idx: int) -> Callable[[], Sample]:
        if self.dataset in ("paco_lvis", "pascal_part"):
            return self._plan_parts(idx)
        present = []
        for _ in range(len(self)):
            lab = self._remap(_read_label_png(self.labels[idx]))
            present = [int(c) for c in np.unique(lab) if c != self.IGNORE]
            if present:
                break
            idx = (idx + 1) % len(self)
        if not present:
            raise ValueError(
                f"sem_seg {self.dataset}: every label map is all-ignore")
        ids = self._pick(present)
        names = [self.classes[cid] for cid in ids]
        qa = [self._short_qa(name) for name in names]
        img_path = self.images[idx]

        def build() -> Sample:
            masks = [(lab == cid).astype(np.float32) for cid in ids]
            return self._sample(img_path, load_rgb(img_path),
                                [c for c, _ in qa], [q for _, q in qa],
                                names, masks, masks[0])

        return build

    def _plan_parts(self, idx: int) -> Callable[[], Sample]:
        img_id = self.img_ids[idx]
        info = self.img_info[img_id]
        if self.dataset == "pascal_part":
            # images under VOCdevkit (sem_seg_dataset.py:200-205)
            img_path = join(self.base_dir, "vlpart", "pascal_part",
                            "VOCdevkit", "VOC2010", "JPEGImages",
                            info["file_name"])
        else:
            img_path = join(self.base_dir, "coco", info["file_name"])
        picked = self._pick(self.img_anns[img_id])
        names = []
        for ann in picked:
            cls = self.class_map[ann["category_id"]]
            if isinstance(cls, tuple):
                obj, part = cls
                # 50/50 phrase forms (:229-235)
                names.append(obj + " " + part if self.rng.random() < 0.5
                             else f"the {part} of the {obj}")
            else:
                names.append(cls)
        qa = [self._short_qa(name) for name in names]

        def build() -> Sample:
            img = load_rgb(img_path)
            masks = [_coco_ann_to_mask(ann, img.shape[0], img.shape[1])
                     for ann in picked]
            return self._sample(img_path, img, [c for c, _ in qa],
                                [q for _, q in qa], names, masks, masks[0])

        return build


DATASET_REGISTRY = {
    "hcontact": HContactDataset,
    "hcontact_scene": HContactSceneDataset,
    "oafford": OAffordDataset,
    "ocontact": OContactDataset,
    "h2dcontact": H2DContactDataset,
    "vqa": VQADataset,
    "refer_seg": ReferSegDataset,
    "refer_seg_lisa": ReferSegLISADataset,
    "reason_seg": ReasonSegDataset,
    "sem_seg": SemSegDataset,
    "sem_seg_lisa": SemSegLISADataset,
}

# datasets whose choice()/sample() calls only ever pick QUESTION/ANSWER
# templates, so TemplateFixedRandom is safe. oafford/ocontact qualify: their
# content randomness is randrange (missing-file retry) and shuffle (ranked
# object matches), neither of which TemplateFixedRandom overrides.
# refer/sem/reason/vqa pick sentences/classes/annotations with choice/sample
# and would collapse.
FIXED_TEMPLATE_SAFE = frozenset({
    "hcontact", "hcontact_scene", "h2dcontact", "oafford", "ocontact",
})


def build_dataset(name: str, base_dir: str, split: str, args):
    """One construction path for train, train-time validation, and the eval
    CLI. ``args`` is any namespace carrying the training hyper-parameters
    (train ``parse_args`` output or the re-hydrated ``pretrained_config``).

    Centralizing this keeps the three entry points' prompt families, view types
    and vertex counts identical by construction (the reference re-derives
    them from one restored config for the same reason,
    ``utils/eval_utils.py:215-244``); divergent per-entry-point copies previously
    scored hcontact_scene with the wrong prompt family and dropped the
    hcontact view_type from the eval CLI.

    ``fixed_templates`` on a set outside ``FIXED_TEMPLATE_SAFE`` raises
    ``ValueError``."""
    ctor = DATASET_REGISTRY[name]
    kw = dict(
        image_size=args.image_size, clip_size=args.clip_size, split=split
    )
    if name in ("hcontact", "hcontact_scene"):
        nv = getattr(args, "num_human_vertices", None)
        if nv:
            kw["num_vertices"] = nv
    if name == "hcontact":
        # scene keeps its own defaults (question_type='simple',
        # hcontactScene_3d.py:53); the hC_* flags configure DAMON/LEMON
        vt = getattr(args, "hC_sam_view_type", None)
        if vt:
            kw["view_type"] = vt
        qt = getattr(args, "hC_question_type", None)
        if qt:
            kw["question_type"] = qt
    elif name == "oafford":
        vt = getattr(args, "oC_sam_view_type", None)
        if vt:
            kw["view_type"] = vt
        qt = getattr(args, "oC_question_type", None)
        if qt:
            kw["question_type"] = qt
        n_points = getattr(args, "num_object_points", None)
        if n_points:
            kw["num_points"] = n_points
    elif name == "ocontact":
        # the reference configures both object datasets from ONE
        # OC_SAM_VIEW_TYPE (run_train.sh:169); PICO trees are rendered
        # with mesh views (..._BM), so only forward explicit mesh types
        vt = getattr(args, "oC_sam_view_type", None)
        if vt and "BM" in vt:
            kw["view_type"] = vt
    if getattr(args, "num_conversations", 1) > 1 and name in (
        "sem_seg", "sem_seg_lisa", "refer_seg", "refer_seg_lisa"
    ):
        kw["num_classes_per_sample"] = args.num_conversations
    ds = ctor(base_dir, **kw)
    if getattr(args, "fixed_templates", False):
        if name not in FIXED_TEMPLATE_SAFE:
            raise ValueError(
                f"--fixed_templates collapses content sampling for "
                f"'{name}' (it picks sentences/classes/annotations with "
                f"the same rng); only {sorted(FIXED_TEMPLATE_SAFE)} "
                f"are supported"
            )
        ds.rng = TemplateFixedRandom(42)
    return ds
