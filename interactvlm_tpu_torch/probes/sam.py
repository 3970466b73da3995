"""SAM encoder probe: the ViT-H encode at 1024^2 over variants that take
its parts away, to localize where the encoder's time goes.

Port of ``scripts/sam_probe.py``. Variants:

  full      the encoder as it serves: window attention (kernel 2) in 28
            blocks, global rel-pos attention (kernel 3) in 4
  norel     the rel-pos bias off (``SAMConfig.use_rel_pos``): the 4 global
            blocks take the flash kernel (kernel 1) at head dim 80 padded
            to 128, the windows the plain attention
  int8      int8 linears (``weights_int8``, kernel 6: kernels 7 + 8 at
            these rows) with the tanh GELU in lin1's epilogue, as the
            serving int8 encoder is built
  int8erf   int8 linears with the exact GELU
  noattn    attention replaced by the identity (``identity_attention``;
            the qkv's first third to proj), tanh GELU: the matmul legs
  noattn8   noattn with int8 linears
  gelutanh  the full encoder with the tanh GELU

Usage: python -m interactvlm_tpu_torch.probes.sam [variant ...]
(default: full norel). Env: PROBE_BATCH (8), PROBE_SIZE (1024 on the card,
256 on the CPU), PROBE_ITERS (3). Runs on the card in bf16;
``main(..., device="cpu")`` runs the plain versions in f32. A variant that
fails or gives a non-finite output raises; so does an unknown one. The
MFU is against the H100's bf16 peak.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import torch

from interactvlm_tpu_torch.config import sam_vit_h
from interactvlm_tpu_torch.models.sam.image_encoder import ImageEncoderViT
from interactvlm_tpu_torch.probes.common import (
    BF16_PEAK,
    check_variants,
    launch_counts,
    launches_since,
    require_finite,
    sam_encoder_flops,
)
from interactvlm_tpu_torch.utils.device import resolve_device, timed
from interactvlm_tpu_torch.utils.weights import init_params

VARIANTS = ("full", "norel", "int8", "int8erf", "noattn", "noattn8",
            "gelutanh")
DEFAULT_VARIANTS = ("full", "norel")


def variant_config(base, name: str):
    """The encoder configuration of variant ``name``."""
    changes = {
        "full": {},
        "norel": dict(use_rel_pos=False),
        "int8": dict(weights_int8=True, gelu_approx=True),
        "int8erf": dict(weights_int8=True),
        "noattn": dict(gelu_approx=True, identity_attention=True),
        "noattn8": dict(weights_int8=True, gelu_approx=True,
                        identity_attention=True),
        "gelutanh": dict(gelu_approx=True),
    }[name]
    return dataclasses.replace(base, **changes)


def main(argv=None, device="cuda", B=None, S=None, iters=None, base=None):
    """Time each named variant's encode of B images; returns {variant:
    {"ms", "views_per_s", "mfu", "launches", "build_s"}}, the launches
    being each kernel's over one encode."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    B = B or int(os.environ.get("PROBE_BATCH", "8"))
    S = S or int(os.environ.get("PROBE_SIZE", "1024" if on_card else "256"))
    iters = iters or int(os.environ.get("PROBE_ITERS", "3"))
    names = list(argv) if argv else list(DEFAULT_VARIANTS)
    check_variants("sam", names, VARIANTS)
    dtype = torch.bfloat16 if on_card else torch.float32
    base = base or sam_vit_h()
    base = dataclasses.replace(base, dtype=dtype, img_size=S)
    flops = sam_encoder_flops(base, B)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, S, S, 3, generator=gen, device=dev).to(dtype)
    results = {}
    for name in names:
        t0 = time.perf_counter()
        enc = ImageEncoderViT(variant_config(base, name), device=dev)
        init_params(enc, torch.Generator(device=dev).manual_seed(0))
        enc.requires_grad_(False)
        with torch.inference_mode():
            before = launch_counts()
            out = enc(x)  # warm-up: kernel builds, one encode's launches
            launches = launches_since(before)
            if on_card:
                torch.cuda.synchronize(dev)
            build_s = time.perf_counter() - t0
            require_finite("sam", name, out)

            def run():
                o = None
                for _ in range(iters):
                    o = enc(x)
                return o

            out, dt = timed(run, dev)
        require_finite("sam", name, out)
        dt /= iters
        results[name] = {"ms": dt * 1e3, "views_per_s": B / dt,
                         "mfu": flops / dt / BF16_PEAK if on_card else 0.0,
                         "launches": launches, "build_s": build_s}
        print(f"[probe] {name}: {dt * 1e3:.1f} ms/encode-batch(B={B}) "
              f"{B / dt:.2f} views/s mfu={results[name]['mfu']:.3f} "
              f"(build {build_s:.0f}s) launches {launches}", flush=True)
        del enc, out
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
