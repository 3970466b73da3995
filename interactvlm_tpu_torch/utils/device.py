"""Device selection and timing for the port's entry points."""

from __future__ import annotations

import time

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the GPU unless the caller names
    the CPU. Raises when CUDA is asked for and there is none, so no path
    quietly moves to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "interactvlm_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain versions"
        )
    return dev


def timed(fn, device: torch.device):
    """(fn(), seconds): device time between CUDA events around the call on
    the card, host time on the CPU."""
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return out, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0
