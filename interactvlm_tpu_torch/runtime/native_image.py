"""ctypes binding for the native C++ image decoder (``native/ivlm_io.cpp``).

Port of ``interactvlm_tpu/runtime/native_image.py``. The port builds its
own copy of the shared library with ``g++`` (libpng / libjpeg) into
``build/native/`` at the repository root, the first time a process asks for
it, and never writes under ``native/``. ctypes calls release the GIL, so
the thread pool of ``runtime/prefetch.py`` scales across cores. Without the
toolchain it falls back to the pure-Python transforms, as the JAX package
does; ``loads`` counts the images each decoder read, by format, so a
caller can say which one ran on what.
"""

from __future__ import annotations

import collections
import ctypes
import errno
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "ivlm_io.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
LIB_PATH = os.path.join(BUILD_DIR, "libivlm_io.so")
_CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]
_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None
_build_failed = False
build_error = None
# images decoded per decoder and format ("native_png", "pil_png",
# "pil_jpeg", ...), for the CLIs to report
loads = collections.Counter()


def _build():
    """Compile ``SOURCE`` into ``LIB_PATH`` (a temporary name, then a
    rename, so a concurrent process never loads half a file)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_CXXFLAGS, "-o", tmp, SOURCE, "-lpng",
                        "-ljpeg"], check=True, capture_output=True, text=True)
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _build_failed, build_error
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if not os.path.exists(LIB_PATH) or os.path.getmtime(
                    LIB_PATH) < os.path.getmtime(SOURCE):
                _build()
            lib = ctypes.CDLL(LIB_PATH)
            lib.ivlm_image_size.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.ivlm_decode_rgb.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ]
            lib.ivlm_sam_preprocess.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ]
            _lib = lib
        except (OSError, subprocess.CalledProcessError) as e:
            build_error = getattr(e, "stderr", None) or str(e)
            _build_failed = True
            _lib = None
        return _lib


def _count(decoder_name: str, path: str):
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    key = f"{decoder_name}_{'jpeg' if ext == 'jpg' else ext}"
    with _count_lock:  # the loader's threads count concurrently
        loads[key] += 1


def available() -> bool:
    return _load() is not None


def decoder() -> str:
    """The decoder this process uses for PNGs: "native" or "pil"."""
    return "native" if available() else "pil"


def decode_rgb(path: str) -> np.ndarray:
    """Decode PNG/JPEG to RGB uint8 (H, W, 3) via the native decoder."""
    lib = _load()
    if lib is None:
        from interactvlm_tpu_torch.data.transforms import load_image_rgb

        _count("pil", path)
        return load_image_rgb(path)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.ivlm_image_size(path.encode(), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        if not os.path.exists(path):
            # as PIL raises it: the datasets' missing-file retry catches it
            raise FileNotFoundError(errno.ENOENT, "no such file", path)
        raise IOError(f"native decode failed ({rc}): {path}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.ivlm_decode_rgb(
        path.encode(), out.ctypes.data_as(ctypes.c_void_p), h, w
    )
    if rc != 0:
        raise IOError(f"native decode failed ({rc}): {path}")
    _count("native", path)
    return out


def load_rgb(path: str) -> np.ndarray:
    """The datasets' image load: PNGs through ``decode_rgb`` (lossless, so
    the same bytes as PIL's), other formats through PIL, as the JAX
    datasets decode every image (JPEG decoders differ in their IDCT's
    rounding)."""
    if path.lower().endswith(".png"):
        return decode_rgb(path)
    from interactvlm_tpu_torch.data.transforms import load_image_rgb

    _count("pil", path)
    return load_image_rgb(path)


def sam_preprocess_native(path: str, target: int = 1024):
    """Fused decode + longest-side resize + normalize + pad.

    Returns (tensor (target, target, 3) float32, (resized_h, resized_w)).
    """
    lib = _load()
    if lib is None:
        from interactvlm_tpu_torch.data.transforms import (
            load_image_rgb,
            sam_preprocess,
        )

        _count("pil", path)
        return sam_preprocess(load_image_rgb(path), target)
    from interactvlm_tpu_torch.utils.constants import (
        SAM_MEAN_PIXEL,
        SAM_STD_PIXEL,
    )

    mean = np.asarray(SAM_MEAN_PIXEL, np.float32)
    std = np.asarray(SAM_STD_PIXEL, np.float32)
    out = np.empty((target, target, 3), np.float32)
    rh = ctypes.c_int()
    rw = ctypes.c_int()
    rc = lib.ivlm_sam_preprocess(
        path.encode(), target,
        mean.ctypes.data_as(ctypes.c_void_p),
        std.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(rh), ctypes.byref(rw),
    )
    if rc != 0:
        raise IOError(f"native preprocess failed ({rc}): {path}")
    _count("native", path)
    return out, (rh.value, rw.value)
