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
through PIL. The LISA segmentation datasets are not ported yet:
``build_dataset`` raises for them.

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
import os
import pickle
import random
import threading
from os.path import join
from typing import Callable, List, Optional, Sequence

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
    ):
        self.base_dir = base_dir
        self.view_set = view_set
        self.image_size = image_size
        self.clip_size = clip_size
        self.conv_type = conv_type
        self.token_type = token_type
        self.rng = rng or random.Random(42)

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


DATASET_REGISTRY = {
    "hcontact": HContactDataset,
    "hcontact_scene": HContactSceneDataset,
    "oafford": OAffordDataset,
    "ocontact": OContactDataset,
    "h2dcontact": H2DContactDataset,
    "vqa": VQADataset,
}
# the JAX package's other datasets and the ROADMAP item that ports them
UNPORTED = {
    name: "ROADMAP Queue A item 2 (the LISA datasets)"
    for name in ("refer_seg", "refer_seg_lisa", "reason_seg", "sem_seg",
                 "sem_seg_lisa")
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

    Names the port has no dataset for yet raise ``NotImplementedError``
    with the ROADMAP item that ports them; ``fixed_templates`` on a set
    outside ``FIXED_TEMPLATE_SAFE`` raises ``ValueError``."""
    if name in UNPORTED:
        raise NotImplementedError(
            f"dataset '{name}' is not ported to interactvlm_tpu_torch yet: "
            f"{UNPORTED[name]}")
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
