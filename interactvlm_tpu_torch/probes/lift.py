"""Lift-leg probe: the 2D -> 3D lift of a serving batch's low-res mask
logits, three ways, at B = 8, V = 4, 256^2 -> 1024^2, N = 4722 vertices
(``bench.py``'s test body under the first four ``4MV-Z_Vitru_mv2``
cameras) and K = 256 gathered pixels a vertex and view.

Port of ``scripts/lift_probe.py``. Variants:

  vmap_lowres     ``geometry/lift.py:lift_multiview_soft_gather_lowres``
                  on each sample (four bilinear taps at the low-res logits
                  for every gathered pixel; no full-res masks)
  resize_gather   ``F.interpolate`` bilinear (``align_corners=False``,
                  which equals ``jax.image.resize`` when upsampling) to
                  full res, then ``lift_multiview_soft_gather`` per sample
  resize_scatter  the same resize, then the scatter lift that
                  ``evaluate_batch`` uses (``lift_batch_soft``)

Each variant prints its time, its peak memory, and its largest difference
from ``resize_scatter``'s output on the same logits (computed once, as
the reference, whether or not it is timed).

Usage: python -m interactvlm_tpu_torch.probes.lift [variant ...]
(default: all three). Env: PROBE_BATCH (8), PROBE_ITERS (10), PROBE_SIZE
(1024 on the card, 256 on the CPU). Runs on the card;
``main(..., device="cpu")`` runs the plain versions. A variant that fails
or gives non-finite values raises; so does an unknown one.
"""

from __future__ import annotations

import os
import sys
import time

import torch
import torch.nn.functional as F

from interactvlm_tpu_torch.geometry.lift import (
    build_gather_maps,
    corner_major,
    lift_batch_soft,
    lift_multiview_soft_gather,
    lift_multiview_soft_gather_lowres,
)
from interactvlm_tpu_torch.geometry.rasterizer import (
    build_lift_maps,
    pick_window,
)
from interactvlm_tpu_torch.geometry.views import HUMAN_VIEWS
from interactvlm_tpu_torch.probes.common import (
    check_variants,
    peak_gb,
    require_finite,
    reset_peak,
    sphere,
)
from interactvlm_tpu_torch.utils.device import resolve_device, timed

VARIANTS = ("vmap_lowres", "resize_gather", "resize_scatter")
V = 4
MAX_K = 256


def lift_maps(H: int, dev, mesh=None, max_k: int = MAX_K, views: int = V):
    """The test body's maps at H^2 under the first ``views`` cameras,
    rasterized on ``dev``: corner-major (p2v, bary), the gather form (built
    on the host) and the vertex count."""
    verts, faces = mesh if mesh is not None else sphere()
    cams = HUMAN_VIEWS["4MV-Z_Vitru_mv2"].cam_params()[:views]
    window = max(pick_window(verts, faces, c, H) for c in cams)
    p2v, bary, _ = build_lift_maps(verts, faces, cams, H, window,
                                   device=dev)
    gidx, gw = build_gather_maps(p2v.cpu().numpy(), bary.cpu().numpy(),
                                 len(verts), max_k=max_k)
    return (corner_major(p2v), corner_major(bary),
            torch.from_numpy(gidx).to(dev), torch.from_numpy(gw).to(dev),
            len(verts))


def variants(p2v, bary, gidx, gw, n_verts, H):
    def resize(low):
        return F.interpolate(low, size=(H, H), mode="bilinear",
                             align_corners=False)

    return {
        "vmap_lowres": lambda low: torch.stack([
            lift_multiview_soft_gather_lowres(m, gidx, gw, (H, H))
            for m in low]),
        "resize_gather": lambda low: torch.stack([
            lift_multiview_soft_gather(m, gidx, gw) for m in resize(low)]),
        "resize_scatter": lambda low: lift_batch_soft(resize(low), p2v,
                                                      bary, n_verts),
    }


def main(argv=None, device="cuda", B=None, H=None, iters=None, mesh=None):
    """Time each named variant; returns {variant: {"ms", "peak_gb",
    "max_abs_diff_vs_scatter"}}, ``maps_s`` (the maps' build time) and,
    where both ran, ``lowres_vs_resize_gather``."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    B = B or int(os.environ.get("PROBE_BATCH", "8"))
    iters = iters or int(os.environ.get("PROBE_ITERS", "10"))
    H = H or int(os.environ.get("PROBE_SIZE", "1024" if on_card else "256"))
    names = list(argv) if argv else list(VARIANTS)
    check_variants("lift", names, VARIANTS)
    h = H // 4
    t0 = time.perf_counter()
    p2v, bary, gidx, gw, n_verts = lift_maps(H, dev, mesh)
    maps_s = time.perf_counter() - t0
    print(f"[lift probe] B={B} V={V} {h}x{h}->{H}x{H} N={n_verts} "
          f"K={gidx.shape[-1]} (maps {maps_s:.1f}s)", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    low = torch.randn(B, V, h, h, generator=gen, device=dev) * 4
    fns = variants(p2v, bary, gidx, gw, n_verts, H)
    results, outs = {"maps_s": maps_s}, {}
    with torch.inference_mode():
        ref = fns["resize_scatter"](low)
        require_finite("lift", "resize_scatter", ref)
        for name in names:
            fns[name](low)  # warm-up
            reset_peak(dev)

            def run():
                out = None
                for i in range(iters):
                    out = fns[name](low + i * 1e-6)
                return out

            _, dt = timed(run, dev)
            peak = peak_gb(dev)
            out = fns[name](low)
            require_finite("lift", name, out)
            diff = (out - ref).abs().max().item()
            dt /= iters
            results[name] = {"ms": dt * 1e3, "peak_gb": peak,
                             "max_abs_diff_vs_scatter": diff}
            print(f"[lift probe] {name}: {dt * 1e3:.1f} ms/batch(B={B}) "
                  f"peak " + ("not measured" if peak is None
                              else f"{peak:.2f} GB")
                  + f" max|diff| vs resize_scatter {diff:.3g}", flush=True)
            outs[name] = out
    if {"vmap_lowres", "resize_gather"} <= set(outs):
        # the same function two ways: equal to f32 rounding
        results["lowres_vs_resize_gather"] = (
            outs["vmap_lowres"] - outs["resize_gather"]).abs().max().item()
        print(f"[lift probe] vmap_lowres against resize_gather: max|diff| "
              f"{results['lowres_vs_resize_gather']:.3g}", flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
