"""Window-attention probe: one attention layer operation of SAM ViT-H at its
real shapes, with variants that isolate the kernel, the rel-pos factor
einsums, the memory floor and the plain path.

Port of ``scripts/winattn_probe.py``. Window shapes: BW windows (200 = 8
images x 25) x 16 heads, 14 x 14 tokens, D = 80; global shapes: 8 images x
16 heads over the 64 x 64 grid, D = 80. Variants:

  xla               decomposed_rel_pos_bias + attention_plain (the plain
                    path, the bias materialised)
  kernel            fused_window_attention: the factors, then kernel 2
  kernel_nofactors  kernel 2 on zero factors: the kernel alone
  kernel_copy       the copy kernel: reads q, k and v in kernel 2's grid
                    and writes q, the memory floor under kernel 2
  pads_only         q, k and v padded to the TPU kernel's (224, 128) tiles
                    and summed: what the padding cost the TPU path
  factors_only      window_factors: the two rel-pos einsums alone
  qkvproj           the block's two projections at these shapes, for scale
  global_fused      fused_rel_attention over the global grid (kernel 3)
  global_plain      flash_attention over the global grid, no bias (kernel
                    1, its head dim zero-padded to 128 as the JAX flash
                    wrapper pads it)

Each variant runs ``iters`` times in a chain (q is nudged by the previous
output's mean, so no call can be skipped), timed with CUDA events.

Usage: python -m interactvlm_tpu_torch.probes.winattn [variant ...]
Env: PROBE_BW (default 200), PROBE_ITERS (default 10). Runs on the card in
bf16; ``main(..., device="cpu")`` runs the plain versions in f32, as the
JAX probe does off the TPU. A variant that fails raises.
"""

from __future__ import annotations

import os
import sys
import time

import torch
import torch.nn.functional as F

from interactvlm_tpu_torch.models.sam.image_encoder import (
    decomposed_rel_pos_bias,
)
from interactvlm_tpu_torch.ops import sam_attention as sa
from interactvlm_tpu_torch.ops.attention import attention_plain
from interactvlm_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_forward,
)
from interactvlm_tpu_torch.utils.device import resolve_device, timed

VARIANTS = ("xla", "kernel", "kernel_nofactors", "kernel_copy", "pads_only",
            "factors_only", "qkvproj", "global_fused", "global_plain")
DEFAULT_VARIANTS = VARIANTS[:3]  # the JAX probe's default list
NH, H, W, D = 16, 14, 14, 80
GB, GH, GW, GD = 8, 16, 64, 80
LG, DP = 224, 128  # the TPU window kernel's padded tile
FLASH_D = 128  # the head dim the global_plain variant pads to
# the wrapper of the hand-written kernel each variant launches, once a layer
# operation
KERNELS = {"kernel": sa.window_attention,
           "kernel_nofactors": sa.window_attention,
           "kernel_copy": sa.window_copy, "global_fused": sa.rel_attention,
           "global_plain": flash_forward}


def variants(bw, dev, dtype, global_batch=GB, global_side=GW):
    """The layer operations, each f(q, k, v) on (bw, 16, 196, 80), with the
    global-grid inputs and the other constants drawn once from a seeded
    generator."""
    L, R = H * W, bw * NH
    gen = torch.Generator(device=dev).manual_seed(1)

    def draw(shape, scale=1.0, dt=dtype):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    rh = draw((2 * H - 1, D), 0.5, torch.float32)
    rw = draw((2 * W - 1, D), 0.5, torch.float32)
    GL = global_side * global_side
    gq, gk, gv = (draw((global_batch, GH, GL, GD)) for _ in range(3))
    grh = draw((2 * global_side - 1, GD), 0.5, torch.float32)
    zeros = torch.zeros(R, H + W, L, dtype=dtype, device=dev)
    w1 = torch.ones(NH * D, 3 * NH * D, dtype=dtype, device=dev)
    w2 = torch.ones(NH * D, NH * D, dtype=dtype, device=dev)

    def rows(t):
        return t.reshape(R, L, D)

    def pad(t):
        return F.pad(t, (0, DP - D, 0, LG - L))

    def pad_d(t):
        return F.pad(t, (0, FLASH_D - GD))

    def xla(q, k, v):
        bias = decomposed_rel_pos_bias(q, rh.to(q.dtype), rw.to(q.dtype),
                                       (H, W))
        return attention_plain(q, k, v, bias=bias, scale=D ** -0.5)

    def kernel(q, k, v):
        return sa.fused_window_attention(q, k, v, rh, rw, (H, W))

    def kernel_nofactors(q, k, v):
        out = sa.window_attention(rows(q), rows(k), rows(v), zeros, (H, W))
        return out.reshape(q.shape)

    def kernel_copy(q, k, v):
        return sa.window_copy(rows(q), rows(k), rows(v)).reshape(q.shape)

    def pads_only(q, k, v):
        return (pad(q) + pad(k) + pad(v))[:, :, :L, :D]

    def factors_only(q, k, v):
        return sa.window_factors(q, rh, rw, (H, W))[..., :D]

    def qkvproj(q, k, v):
        x = q.transpose(1, 2).reshape(bw * L, NH * D)
        y = (x @ w1)[:, :NH * D]
        return (y @ w2).reshape(bw, L, NH, D).transpose(1, 2)

    def global_fused(q, k, v):
        # q's mean keeps each call dependent on the previous one
        return sa.fused_rel_attention(gq + q.mean() * 1e-9, gk, gv, grh, grh,
                                      (global_side, global_side))

    def global_plain(q, k, v):
        out = flash_attention(pad_d(gq + q.mean() * 1e-9), pad_d(gk),
                              pad_d(gv), scale=GD ** -0.5)
        return out[..., :GD]

    return {f.__name__: f for f in (
        xla, kernel, kernel_nofactors, kernel_copy, pads_only, factors_only,
        qkvproj, global_fused, global_plain)}


def chained(f, q, k, v, iters):
    acc = torch.zeros((), dtype=torch.float32, device=q.device)
    for _ in range(iters):
        # cast back: acc is f32 and would promote q
        acc = f((q + acc * 1e-6).to(q.dtype), k, v).mean(dtype=torch.float32)
    return acc


def main(argv=None, device="cuda", bw=None, iters=None, global_batch=GB,
         global_side=GW):
    """Time each named variant (all nine in ``VARIANTS`` are known); returns
    {variant: {"ms_per_op", "first_run_s", "launches"}}, the launches being
    the hand-written kernel's count over the timed chain."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    bw = bw or int(os.environ.get("PROBE_BW", "200"))
    iters = iters or int(os.environ.get("PROBE_ITERS", "10"))
    names = list(argv) if argv else list(DEFAULT_VARIANTS)
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        raise ValueError(f"winattn: unknown variants {unknown}; known: "
                         f"{VARIANTS}")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((bw, NH, H * W, D), generator=gen,
                           device=dev).to(dtype) for _ in range(3))
    results = {}
    with torch.inference_mode():
        fns = variants(bw, dev, dtype, global_batch, global_side)
        for name in names:
            f = fns[name]
            t0 = time.perf_counter()
            chained(f, q, k, v, iters)
            if on_card:
                torch.cuda.synchronize(dev)
            first = time.perf_counter() - t0  # with the kernels' build
            counter = KERNELS.get(name)
            before = counter.launches if counter else 0
            out, dt = timed(lambda: chained(f, q, k, v, iters), dev)
            if not bool(torch.isfinite(out)):
                raise RuntimeError(f"winattn: {name} gave a non-finite value")
            ms = dt / iters * 1e3
            results[name] = {
                "ms_per_op": ms, "first_run_s": first,
                "launches": ({counter.__name__: counter.launches - before}
                             if counter else {})}
            print(f"[winattn] {name} ({dev.type}): {ms:.3f} ms/layer-op "
                  f"(first run {first:.1f} s)", flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
