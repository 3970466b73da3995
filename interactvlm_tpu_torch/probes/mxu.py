"""Tensor-core rate probe: time a loop of products of one operand pair, per
operand and accumulator type, to read the card's matrix rate apart from
device-memory traffic.

Port of ``scripts/mxu_probe.py``: out = f32(sum over ``loops`` of x @ W^T) at
M, K, N = 512, 1280, 1280 through ``ops/mxu.mxu_loop`` (kernel 11), in bf16
-> f32, int8 -> int32, int8 -> f32 and f32 -> f32. Two loop counts are
timed (loops / 4 and loops) and their difference taken, so the launch cost
drops out.

Usage: python -m interactvlm_tpu_torch.probes.mxu
Env: MXU_LOOPS (default 2048). Runs on the card; ``main(device="cpu",
...)`` runs the plain version. A combination that fails raises.
"""

from __future__ import annotations

import os

import torch

from interactvlm_tpu_torch.ops.mxu import mxu_loop
from interactvlm_tpu_torch.utils.device import resolve_device, timed

M, K, N = 512, 1280, 1280
COMBOS = (("bf16xbf16->f32", torch.bfloat16, torch.float32),
          ("int8xint8->int32", torch.int8, torch.int32),
          ("int8xint8->f32", torch.int8, torch.float32),
          ("f32xf32->f32", torch.float32, torch.float32))


def make_inputs(in_dtype, shape, device, seed=0):
    """x (M, K) and W (N, K): uniform integers in [-127, 127] for int8,
    standard normals otherwise, from a seeded generator on ``device``."""
    m, k, n = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    if in_dtype == torch.int8:
        return tuple(torch.randint(-127, 128, s, generator=gen, device=device,
                                   dtype=torch.int8) for s in ((m, k), (n, k)))
    return tuple(torch.randn(s, generator=gen, device=device).to(in_dtype)
                 for s in ((m, k), (n, k)))


def main(device="cuda", loops=None, shape=(M, K, N)):
    """Time each combination; returns {name: {"us_per_dot", "tops"}}."""
    dev = resolve_device(device)
    loops = loops or int(os.environ.get("MXU_LOOPS", "2048"))
    small = max(1, loops // 4)
    if loops <= small:
        raise ValueError(f"mxu: loops must exceed {small}, got {loops}")
    flops = 2.0 * shape[0] * shape[1] * shape[2]
    results = {}
    with torch.inference_mode():
        for name, in_dtype, acc_dtype in COMBOS:
            x, w = make_inputs(in_dtype, shape, dev)
            mxu_loop(x, w, loops, acc_dtype)  # warm-up: the kernel's build
            _, t_small = timed(lambda: mxu_loop(x, w, small, acc_dtype), dev)
            out, t_big = timed(lambda: mxu_loop(x, w, loops, acc_dtype), dev)
            if not bool(torch.isfinite(out).all()):
                raise RuntimeError(f"mxu: {name} gave non-finite values")
            dt = (t_big - t_small) / (loops - small)
            results[name] = {"us_per_dot": dt * 1e6,
                             "tops": flops / dt / 1e12 if dt > 0 else None}
            print(f"[mxu] {name} ({dev.type}): {dt * 1e6:.2f} us/dot  "
                  f"{flops / dt / 1e12 if dt > 0 else float('nan'):.1f} Tops",
                  flush=True)
    return results


if __name__ == "__main__":
    main()
