"""Observability: profiler capture, step timing, and metric logging.

Port of ``interactvlm_tpu/utils/profiling.py`` (the reference has only
wall-clock meters + TB logging):
- ``profile_trace``: a ``torch.profiler`` capture of the host and the card,
  written as a Chrome trace into ``log_dir``;
- ``annotate``: a named range on the trace (``torch.profiler``'s, and an
  NVTX range on the card);
- ``StepTimer``: the data/step wall-clock split (the reference's
  data_time/batch_time meters, train.py:485-486);
- ``MetricLogger``: JSONL metric stream (always) + an optional TensorBoard
  mirror when that package exists (reference utils/utils.py:445-482); a
  mirror that cannot start is left out, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture the CPU and, where there is one, the card with
    ``torch.profiler`` while the block runs, then write the Chrome trace
    ``log_dir/trace.json``; yields that path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(path)


# the names ``annotate`` has given regions in this process
ANNOTATIONS: set = set()


@contextlib.contextmanager
def annotate(name: str):
    """A named region of the trace (the JAX package's ``annotate``, an xprof
    TraceAnnotation): ``torch.profiler.record_function``, which a
    ``profile_trace`` capture shows, and an NVTX range where a card is
    initialised, which tools that read NVTX show. The profiler mirrors each
    region onto the card's timeline as an event of its own, which is no
    kernel: readers of device time leave out the names in
    ``ANNOTATIONS``."""
    import torch

    ANNOTATIONS.add(name)
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """One step's wall clock: ``start`` before fetching the batch,
    ``mark_data`` once it is in hand, ``mark_step`` once the step is done
    (synchronised). ``data_s`` is the wait for the batch, ``step_s`` the
    whole step, the wait included."""

    def __init__(self):
        self.start()

    def start(self):
        self.t0 = time.perf_counter()
        self.data_s = self.step_s = 0.0

    def mark_data(self):
        self.data_s = time.perf_counter() - self.t0

    def mark_step(self):
        self.step_s = time.perf_counter() - self.t0
        return {"data_secs": self.data_s, "step_secs": self.step_s}


class MetricLogger:
    """JSONL metrics with an optional TensorBoard mirror."""

    def __init__(self, log_dir: str, use_tb: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self.tb = None
        if use_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(os.path.join(log_dir, "tb"))
            except Exception:  # no tensorboard package: JSONL only
                pass

    def log(self, step: int, metrics: Dict[str, float]):
        rec = {"step": int(step)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError, RuntimeError):
                continue
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.tb is not None:
            for k, v in rec.items():
                if k != "step":
                    self.tb.add_scalar(k, v, step)

    def log_images(self, step: int, tag: str, image):
        """Log one (H, W, 3) float [0,1] image panel to TensorBoard
        (reference image panels, utils/utils.py:457-470)."""
        if self.tb is not None:
            import numpy as _np

            arr = _np.clip(_np.asarray(image, _np.float32), 0.0, 1.0)
            self.tb.add_image(tag, arr, step, dataformats="HWC")

    def close(self):
        self._f.close()
        if self.tb is not None:
            self.tb.close()


def mask_panel(clip_img, sam_img, pred_mask, gt_mask):
    """Concatenate CLIP image | SAM view | predicted mask | GT mask into one
    horizontal panel (the reference's TB image layout,
    utils/utils.py:457-470). Inputs are numpy arrays; masks are logits/
    labels and get normalized to [0, 1] grayscale RGB."""
    import numpy as np

    def to_rgb01(x):
        x = np.asarray(x, np.float32)
        if x.ndim == 2:
            x = x[..., None].repeat(3, axis=-1)
        lo, hi = x.min(), x.max()
        return (x - lo) / (hi - lo + 1e-8)

    h = min(
        np.asarray(a).shape[0] for a in (clip_img, sam_img, pred_mask, gt_mask)
    )

    def fit(x):
        x = to_rgb01(x)
        s = x.shape[0] // h
        return x[::s, ::s][:h, :h] if s > 1 else x[:h, :h]

    return np.concatenate(
        [fit(clip_img), fit(sam_img), fit(pred_mask), fit(gt_mask)], axis=1
    )


def copy_code_snapshot(run_dir: str):
    """Snapshot the port's sources into the run dir for reproducibility
    (reference ``copy_code``, utils/utils.py:402-425). Kernel builds are
    not sources and stay out."""
    import shutil

    root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    dst = os.path.join(run_dir, "code_snapshot")
    src = os.path.join(root, "interactvlm_tpu_torch")
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(
        src, os.path.join(dst, "interactvlm_tpu_torch"),
        ignore=shutil.ignore_patterns("__pycache__", "*.pyc", "*.so"),
    )
    return dst
