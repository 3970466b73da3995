"""Checkpoints: step and best-metric checkpoints in torch's format, and the
run's config files.

Port of ``interactvlm_tpu/train/checkpoints.py`` (which replaces the
reference's DeepSpeed flow, ``train.py:421-472``):
- step checkpoints under ``<run>/ckpt/<step>/`` (the newest ``max_to_keep``
  kept) and the best one under ``<run>/ckpt_best/`` with its score in
  ``best_score.json``; a tie updates the best (among equal scores, the most
  trained parameters);
- each save writes a temporary directory, then renames it, so a reader
  never sees half a checkpoint;
- a checkpoint holds the model's whole ``state_dict`` (the JAX
  ``TrainState`` holds every parameter), the optimizer's and the
  scheduler's states and the step (``state.pt``);
- ``config.json`` / ``pretrained_config.json`` persisted next to the run
  (train.py:194-195) and re-hydrated at eval (eval_utils.py:215-244), the
  same JSON as the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

STATE_FILE = "state.pt"


def _to_jsonable(obj):
    if dataclasses.is_dataclass(obj):
        return {
            f.name: _to_jsonable(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, type):
        return str(obj)
    if hasattr(obj, "dtype") and np.ndim(obj) == 0:
        return obj.item()
    if hasattr(obj, "__name__"):
        return obj.__name__
    try:
        json.dumps(obj)
        return obj
    except TypeError:
        return str(obj)


def save_config(run_dir: str, config: Any, name: str = "config.json"):
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, name), "w") as f:
        json.dump(_to_jsonable(config), f, indent=2)


def load_config(run_dir: str, name: str = "config.json") -> Dict:
    with open(os.path.join(run_dir, name)) as f:
        return json.load(f)


def _save_dir(path: str, state: Dict):
    """Write ``state`` to ``path``/state.pt through ``path``.tmp and a
    rename; an existing ``path`` is replaced."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, STATE_FILE))
    old = path + ".old"
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    if os.path.exists(old):
        shutil.rmtree(old)


class CheckpointManager:
    """Step checkpoints + a tracked best checkpoint under ``run_dir``."""

    def __init__(self, run_dir: str, max_to_keep: int = 2):
        self.run_dir = os.path.abspath(run_dir)
        self.ckpt_dir = os.path.join(self.run_dir, "ckpt")
        self.max_to_keep = max_to_keep
        self.best_dir = os.path.join(self.run_dir, "ckpt_best")
        self.best_score: Optional[float] = self._load_best_score()

    def _load_best_score(self):
        meta = os.path.join(self.run_dir, "best_score.json")
        if os.path.exists(meta):
            with open(meta) as f:
                return json.load(f)["score"]
        return None

    def steps(self):
        if not os.path.isdir(self.ckpt_dir):
            return []
        return sorted(int(d) for d in os.listdir(self.ckpt_dir)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.ckpt_dir, d, STATE_FILE)))

    def save(self, step: int, state: Dict):
        """A step checkpoint; keeps the newest ``max_to_keep``."""
        os.makedirs(self.ckpt_dir, exist_ok=True)
        _save_dir(os.path.join(self.ckpt_dir, str(step)), state)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, str(old)))

    def save_best(self, step: int, state: Dict, score: float,
                  higher_is_better: bool = True):
        """Best-metric-gated save (reference train.py:434-468)."""
        improved = (
            self.best_score is None
            # tie -> update: among equal scores prefer the most-trained
            # params (otherwise a flat early metric pins "best" to the
            # first checkpoint forever -- e.g. val F1 0.0 while the CE
            # leg is still learning)
            or score == self.best_score
            or (score > self.best_score) == higher_is_better
        )
        if not improved:
            return False
        self.best_score = score
        _save_dir(self.best_dir, state)
        with open(os.path.join(self.run_dir, "best_score.json"), "w") as f:
            json.dump({"score": score, "step": step}, f)
        return True

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, map_location="cpu"):
        """The state saved at ``step`` (default: the latest), or None."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return torch.load(os.path.join(self.ckpt_dir, str(step), STATE_FILE),
                          map_location=map_location, weights_only=True)

    def restore_best(self, map_location="cpu"):
        path = os.path.join(self.best_dir, STATE_FILE)
        if not os.path.exists(path):
            return None
        return torch.load(path, map_location=map_location, weights_only=True)
