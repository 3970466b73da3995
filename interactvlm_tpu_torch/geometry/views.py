"""Canonical multi-view registry: typed port of the reference's de-facto view
schema (reference ``preprocess_data/constants.py:138-382``), which couples the
datasets, the model's multiview channels, and demo-time cameras.

A copy of ``interactvlm_tpu/geometry/views.py``, owned by the port: numpy
data, no JAX. Each view is described by 5-dof camera parameters ``(dist,
elev, azim, tx, ty)`` in PyTorch3D ``look_at_view_transform`` convention
(degrees), matching the reference camera construction at
``render_mesh_utils.py:115-127``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class ViewSpec:
    """One canonical camera view: 5-dof camera params.

    ``dist``: distance from origin; ``elev``/``azim``: degrees;
    ``tx``/``ty``: post-look-at camera-space translation offsets
    (reference ``render_mesh_utils.py:118-119`` adds them to T).
    """

    name: str
    dist: float
    elev: float
    azim: float
    tx: float = 0.0
    ty: float = 0.0

    @property
    def params(self) -> np.ndarray:
        return np.array(
            [self.dist, self.elev, self.azim, self.tx, self.ty], dtype=np.float32
        )


@dataclasses.dataclass(frozen=True)
class ViewSet:
    """A named set of canonical views used for one task family."""

    key: str
    views: tuple[ViewSpec, ...]
    mask_size: int
    num_vertices: int | None = None  # fixed-topology meshes (SMPL: 6890)
    heatmap: bool = False  # 'HM' view types carry soft heatmap labels
    ignore_keywords: tuple[str, ...] = ()

    @property
    def num_views(self) -> int:
        return len(self.views)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(v.name for v in self.views)

    def cam_params(self, normalized: bool = False) -> np.ndarray:
        """(V, 5) camera-parameter array; optionally normalized for the
        camera-pose encoder (reference ``base_contact_dataset.py:37-50``)."""
        params = np.stack([v.params for v in self.views])
        if normalized:
            return normalize_cam_params(params)
        return params


def normalize_cam_params(params: np.ndarray) -> np.ndarray:
    """Normalize 5-dof camera params for the cam-pose encoder.

    Matches the reference dataset normalization exactly
    (``datasets/base_contact_dataset.py:37-50``): dist/10, elev/360,
    azim/360, translations mapped from [-1, 1] to [0, 1].
    """
    params = np.asarray(params, dtype=np.float32).copy()
    params[..., 0] = params[..., 0] / 10.0
    params[..., 1] = params[..., 1] / 360.0
    params[..., 2] = params[..., 2] / 360.0
    params[..., 3] = (params[..., 3] + 1.0) / 2.0
    params[..., 4] = (params[..., 4] + 1.0) / 2.0
    return params


def _vs(name, p):
    return ViewSpec(name, *p)


# Human canonical-body views (reference constants.py:315-382). The body is a
# fixed Vitruvian-pose SMPL render shared across samples; four views cover
# top/bottom x front/back.
_VITRU_VIEWS = (
    _vs("topfront", (2.0, 45.0, 315.0, 0.0, 0.0)),
    _vs("bottomfront", (2.0, 315.0, 315.0, 0.0, 0.3)),
    _vs("topback", (2.0, 45.0, 135.0, 0.0, 0.0)),
    _vs("bottomback", (2.0, 315.0, 135.0, 0.0, 0.3)),
)

HUMAN_VIEWS: Mapping[str, ViewSet] = {
    "4MV-Z_Vitru": ViewSet(
        key="4MV-Z_Vitru",
        views=_VITRU_VIEWS,
        mask_size=1024,
        num_vertices=6890,
    ),
    "4MV-Z_Vitru_mv2": ViewSet(
        key="4MV-Z_Vitru_mv2",
        views=_VITRU_VIEWS,
        mask_size=1024,
        num_vertices=6890,
    ),
    "4MV-Z_Vitru_FootGround": ViewSet(
        key="4MV-Z_Vitru_FootGround",
        views=_VITRU_VIEWS,
        mask_size=1024,
        num_vertices=6890,
        ignore_keywords=("supporting",),
    ),
}

# Object views (reference constants.py:138-313). Objects are normalized point
# clouds / meshes; four oblique views around the z axis.
_OBJ4_VIEWS = (
    _vs("frontleft", (2.0, 45.0, 315.0, 0.0, 0.0)),
    _vs("frontright", (2.0, 45.0, 45.0, 0.0, 0.0)),
    _vs("backleft", (2.0, 330.0, 135.0, 0.0, 0.0)),
    _vs("backright", (2.0, 330.0, 225.0, 0.0, 0.0)),
)

_OBJ4_MESH_VIEWS = tuple(
    dataclasses.replace(v, dist=1.5) for v in _OBJ4_VIEWS
)  # low-poly mesh renders use dist 1.5 (constants.py:261-266)

_OBJ10_VIEWS = _OBJ4_VIEWS + (
    _vs("top", (2.0, 90.0, 0.0, 0.0, 0.0)),
    _vs("bottom", (2.0, 270.0, 0.0, 0.0, 0.0)),
    _vs("front", (2.0, 0.0, 0.0, 0.0, 0.0)),
    _vs("back", (2.0, 0.0, 180.0, 0.0, 0.0)),
    _vs("left", (2.0, 0.0, 270.0, 0.0, 0.0)),
    _vs("right", (2.0, 0.0, 90.0, 0.0, 0.0)),
)

OBJECT_VIEWS: Mapping[str, ViewSet] = {
    "4MV-Z_Fix": ViewSet(
        key="4MV-Z_Fix",
        views=_OBJ4_VIEWS,
        mask_size=512,
        ignore_keywords=("Refrigerator", "Baseballbat"),
    ),
    "4MV-Z_HM": ViewSet(
        key="4MV-Z_HM", views=_OBJ4_VIEWS, mask_size=1024, heatmap=True
    ),
    "4MV-Z_HM1": ViewSet(
        key="4MV-Z_HM1", views=_OBJ4_VIEWS, mask_size=1024, heatmap=True
    ),
    "4MV-Z_HM2": ViewSet(
        key="4MV-Z_HM2", views=_OBJ4_VIEWS, mask_size=1024, heatmap=True
    ),
    "4MV-Z_HM_MeshInf": ViewSet(
        key="4MV-Z_HM_MeshInf", views=_OBJ4_VIEWS, mask_size=1024, heatmap=True
    ),
    "4MV-Z_HM_BM": ViewSet(
        key="4MV-Z_HM_BM", views=_OBJ4_MESH_VIEWS, mask_size=1024, heatmap=True
    ),
    "4MV-Z_HM_BM-L": ViewSet(
        key="4MV-Z_HM_BM-L", views=_OBJ4_MESH_VIEWS, mask_size=1024, heatmap=True
    ),
    "10MV-Z_HM": ViewSet(
        key="10MV-Z_HM", views=_OBJ10_VIEWS, mask_size=1024, heatmap=True
    ),
}


def get_human_view_set(key: str) -> ViewSet:
    return HUMAN_VIEWS[key]


def get_object_view_set(key: str) -> ViewSet:
    return OBJECT_VIEWS[key]


# Affordance vocabularies (reference constants.py:5-9); needed by the object
# affordance datasets and the demo prompts.
AFFORD_LIST_PIAD: Sequence[str] = (
    "grasp", "contain", "lift", "open", "lay", "sit", "support", "wrapgrasp",
    "pour", "move", "display", "push", "listen", "wear", "press", "cut", "stab",
)

AFFORD_LIST_LEMON: Sequence[str] = (
    "grasp", "lift", "open", "lay", "sit", "support", "wrapgrasp", "pour",
    "move", "pull", "listen", "press", "cut", "stab", "ride", "play", "carry",
)

# DAMON object-category grouping used by the semantic-contact report
# (reference constants.py:388-409).
DAMON_CATEGORIES_MAPPING: Mapping[str, Sequence[str]] = {
    "transport": (
        "motorcycle", "bicycle", "boat", "car", "truck", "bus", "train",
        "airplane",
    ),
    "accessory": ("backpack", "tie", "handbag", "baseball_glove"),
    "furniture": ("bench", "chair", "couch", "bed", "toilet", "dining_table"),
    "everyday-objects": (
        "book", "umbrella", "cell_phone", "laptop", "kite", "suitcase",
        "bottle", "remote", "toothbrush", "teddy_bear", "scissors", "keyboard",
        "hair drier", "traffic light", "fire_hydrant", "stop sign", "tv",
        "vase", "parking meter", "clock", "potted plant", "mouse",
    ),
    "sports": (
        "frisbee", "sports_ball", "tennis_racket", "baseball_bat",
        "skateboard", "snowboard", "skis", "surfboard",
    ),
    "food": (
        "banana", "cake", "apple", "carrot", "pizza", "donut", "hot_dog",
        "sandwich", "broccoli", "orange",
    ),
    "kitchen": (
        "knife", "spoon", "cup", "wine_glass", "oven", "fork", "bowl",
        "refrigerator", "toaster", "sink", "microwave",
    ),
}
