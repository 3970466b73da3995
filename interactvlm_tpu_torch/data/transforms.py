"""Host-side image preprocessing (a copy of
``interactvlm_tpu/data/transforms.py``: the same arrays, bit for bit).

Rebuild of the reference transforms: SAM's ``ResizeLongestSide`` + pixel
normalization + bottom/right zero padding
(``model/segment_anything/utils/transforms.py``; applied at
``datasets/dataset.py:450-460`` / ``base_contact_dataset.py:175-192``) and
CLIP square resize + normalization. Pure numpy; images flow to the device
channels-last. ``_bilinear_resize`` is the JAX package's formula: its
corners are not ``F.interpolate``'s.
"""

from __future__ import annotations

import numpy as np

from interactvlm_tpu_torch.utils.constants import (
    CLIP_MEAN_PIXEL,
    CLIP_STD_PIXEL,
    SAM_MEAN_PIXEL,
    SAM_STD_PIXEL,
)


def _bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Simple half-pixel-center bilinear resize, (H, W, C) float."""
    H, W = img.shape[:2]
    ys = (np.arange(out_h) + 0.5) * H / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * W / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, H - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, W - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    img = img.astype(np.float32)
    if img.ndim == 2:
        img = img[..., None]
        squeeze = True
    else:
        squeeze = False
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    return out[..., 0] if squeeze else out


def resize_longest_side(img: np.ndarray, target: int = 1024) -> np.ndarray:
    """Scale so the longest side equals ``target`` (reference
    transforms.py get_preprocess_shape)."""
    H, W = img.shape[:2]
    scale = target / max(H, W)
    new_h = int(H * scale + 0.5)
    new_w = int(W * scale + 0.5)
    return _bilinear_resize(img, new_h, new_w)


def sam_preprocess(img: np.ndarray, img_size: int = 1024):
    """RGB uint8 (H, W, 3) -> normalized, padded (img_size, img_size, 3).

    Returns (tensor, resize_hw) where resize_hw is the pre-padding size
    (the reference keeps it for postprocess cropping)."""
    resized = resize_longest_side(img.astype(np.float32), img_size)
    h, w = resized.shape[:2]
    x = (resized - np.asarray(SAM_MEAN_PIXEL, np.float32)) / np.asarray(
        SAM_STD_PIXEL, np.float32
    )
    out = np.zeros((img_size, img_size, 3), np.float32)
    out[:h, :w] = x
    return out, (h, w)


def sam_label_preprocess(
    mask: np.ndarray, img_size: int = 1024, ignore: float = -1.0
) -> np.ndarray:
    """Binary label (H, W) -> (img_size, img_size) in the SAM frame:
    longest-side resize + bottom/right pad marked IGNORE. Keeps batched
    training square for real-photo 2D tasks; eval scores the original frame
    via ``models/sam/sam.py:postprocess_masks``."""
    resized = resize_longest_side(mask.astype(np.float32), img_size)
    h, w = resized.shape[:2]
    out = np.full((img_size, img_size), ignore, np.float32)
    out[:h, :w] = (resized >= 0.5).astype(np.float32)
    return out


def clip_preprocess(img: np.ndarray, size: int = 224) -> np.ndarray:
    """RGB uint8 -> CLIP-normalized square (size, size, 3). The HF
    processor center-crops after resizing the short side; canonical inputs
    here are near-square so a direct square resize matches in practice."""
    resized = _bilinear_resize(img.astype(np.float32) / 255.0, size, size)
    return (
        (resized - np.asarray(CLIP_MEAN_PIXEL, np.float32))
        / np.asarray(CLIP_STD_PIXEL, np.float32)
    ).astype(np.float32)


def load_image_rgb(path: str) -> np.ndarray:
    """Load an image file to RGB uint8 (H, W, 3) via PIL."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def valid_region_mask(render: np.ndarray):
    """Non-white region of a canonical render (reference
    base_contact_dataset.py:180-182): channel sum < 255 * 3."""
    return render.astype(np.int32).sum(axis=-1) < 255 * 3
