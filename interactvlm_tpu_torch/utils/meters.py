"""Metric meters with multi-process reduction.

Port of ``interactvlm_tpu/utils/meters.py``, a rebuild of the reference
``AverageMeter`` (utils/utils.py:147-198): ``all_reduce`` sums (sum, count)
over the ``torch.distributed`` group when one is initialised; NaN/Inf
updates are skipped like the reference's guard.
"""

from __future__ import annotations

import enum

import numpy as np


class Summary(enum.Enum):
    NONE = 0
    AVERAGE = 1
    SUM = 2
    COUNT = 3


class AverageMeter:
    def __init__(self, name: str, fmt: str = ":f",
                 summary_type: Summary = Summary.AVERAGE):
        self.name = name
        self.fmt = fmt
        self.summary_type = summary_type
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = np.asarray(val, dtype=np.float64)
        if np.isnan(val).any() or np.isinf(val).any():
            return  # reference skips NaN updates (utils/utils.py:168-174)
        self.val = val
        self.sum = np.asarray(self.sum) + val * n
        self.count += n
        self.avg = self.sum / self.count

    def all_reduce(self):
        """Sum (sum, count) across the torch.distributed group. No-op in
        one process."""
        import torch
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) or (
                dist.get_world_size() == 1):
            return
        flat = torch.from_numpy(np.concatenate(
            [np.asarray(self.sum, dtype=np.float64).reshape(-1),
             np.array([self.count], dtype=np.float64)]))
        dist.all_reduce(flat)
        total = flat.numpy()
        self.sum = total[:-1].reshape(np.shape(self.sum))
        self.count = float(total[-1])
        self.avg = self.sum / (self.count + 1e-5)

    def __str__(self):
        return f"{self.name} {np.asarray(self.val)} ({np.asarray(self.avg)})"


class ProgressMeter:
    """Formats a set of meters per step (reference utils/utils.py:201+)."""

    def __init__(self, num_batches: int, meters, prefix: str = ""):
        self.num_batches = num_batches
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int) -> str:
        entries = [f"{self.prefix}[{batch}/{self.num_batches}]"]
        entries += [str(m) for m in self.meters]
        return "\t".join(entries)
