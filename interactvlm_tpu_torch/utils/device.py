"""Device selection for the port's entry points."""

from __future__ import annotations

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
