"""Int8 matmul probe: the serving matmul variants at the SAM ViT-H
encoder's four linear shapes for B = 8 views (32768 rows).

Port of ``scripts/int8_probe.py``. Shapes (M, K, N): qkv 1280 -> 3840,
proj 1280 -> 1280, mlp1 (lin1) 1280 -> 5120, mlp2 (lin2) 5120 -> 1280.
Variants, each run at every named shape:

  bf16         torch.matmul in bf16, the dense product the JAX package
               leaves to XLA
  xla          the library composition of ``ops/quant.int8_matmul``:
               quantize_int8, torch._int_mm, rescale (a yardstick; the CPU
               takes the exact composition)
  xla_pre      torch._int_mm and the rescale on activations quantized
               beforehand (the library's int8 product alone)
  pallas       ``ops/int8_matmul.int8_matmul_fused`` (kernel 6; at these
               rows its two-pass route, kernels 7 + 8)
  pallas_gelu  the same with the exact-GELU epilogue

Usage: python -m interactvlm_tpu_torch.probes.int8 [shape ...] (default:
all four). Env: PROBE_ITERS (10 on the card, 2 on the CPU), PROBE_M (rows;
32768 on the card, 512 on the CPU). Runs on the card; ``main(...,
device="cpu")`` runs the plain versions. The MFU is against the H100's
bf16 peak (989 TFLOP/s), as the JAX script's is against its chip's bf16
peak. A variant that fails or gives non-finite values raises; so does an
unknown shape.
"""

from __future__ import annotations

import os
import sys

import torch

from interactvlm_tpu_torch.ops.int8_matmul import int8_matmul_fused
from interactvlm_tpu_torch.ops.quant import (
    int8_matmul,
    int_matmul_exact,
    quantize_int8,
)
from interactvlm_tpu_torch.probes.common import (
    BF16_PEAK,
    check_variants,
    launch_counts,
    launches_since,
    require_finite,
)
from interactvlm_tpu_torch.utils.device import resolve_device, timed

SHAPES = {
    "qkv": (32768, 1280, 3840),
    "proj": (32768, 1280, 1280),
    "mlp1": (32768, 1280, 5120),
    "mlp2": (32768, 5120, 1280),
}
VARIANTS = ("bf16", "xla", "xla_pre", "pallas", "pallas_gelu")


def _int_mm(x_q, w_q):
    """(M, K) int8 @ (N, K) int8 -> f32: torch._int_mm on the card, the
    exact sum elsewhere."""
    if x_q.is_cuda:
        return torch._int_mm(x_q, w_q.t()).float()
    return int_matmul_exact(x_q, w_q)


def variants(x, w, w_q, w_s):
    """Each variant's call on x (M, K) bf16 and W (N, K): bf16 and its
    int8 form with per-output-column scales (N,)."""
    x_q, x_s = quantize_int8(x)

    def xla(a):
        if not a.is_cuda:
            return int8_matmul(a, w_q, w_s)
        aq, as_ = quantize_int8(a)
        return (torch._int_mm(aq, w_q.t()).float() * as_ * w_s).to(
            torch.bfloat16)

    return {
        "bf16": lambda: torch.matmul(x, w.t()),
        "xla": lambda: xla(x),
        "xla_pre": lambda: (_int_mm(x_q, w_q) * x_s * w_s).to(
            torch.bfloat16),
        "pallas": lambda: int8_matmul_fused(x, w_q, w_s),
        "pallas_gelu": lambda: int8_matmul_fused(x, w_q, w_s,
                                                 activation="gelu"),
    }


def main(argv=None, device="cuda", M=None, iters=None, names=VARIANTS):
    """Time each variant at each named shape; returns {shape: {variant:
    {"ms", "mfu", "launches"}}}, the launches being each kernel's over one
    call."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    iters = iters or int(os.environ.get("PROBE_ITERS",
                                        "10" if on_card else "2"))
    M = M or int(os.environ.get("PROBE_M", "32768" if on_card else "512"))
    shapes = list(argv) if argv else list(SHAPES)
    check_variants("int8 (shapes)", shapes, SHAPES)
    check_variants("int8", names, VARIANTS)
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for shape in shapes:
        _, K, N = SHAPES[shape]
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn(N, K, generator=gen, device=dev).to(torch.bfloat16)
        w_q, w_s = quantize_int8(w.float())
        fns = variants(x, w, w_q, w_s[:, 0].contiguous())
        flops = 2.0 * M * K * N
        results[shape] = {}
        with torch.inference_mode():
            for name in names:
                before = launch_counts()
                out = fns[name]()  # warm-up: builds, one call's launches
                launches = launches_since(before)
                require_finite("int8", f"{shape} {name}", out)

                def run():
                    o = None
                    for _ in range(iters):
                        o = fns[name]()
                    return o

                out, dt = timed(run, dev)
                require_finite("int8", f"{shape} {name}", out)
                dt /= iters
                mfu = flops / dt / BF16_PEAK if on_card else 0.0
                results[shape][name] = {"ms": dt * 1e3, "mfu": mfu,
                                        "launches": launches}
                print(f"[int8probe] {shape} ({M}x{K}x{N}) {name}: "
                      f"{dt * 1e3:.2f} ms  bf16-mfu={mfu:.2f} "
                      f"launches {launches}", flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
