"""Chained-matmul probe: bf16 against int8 serving matmuls, like for like.

Port of ``scripts/chain_probe.py``. Each iteration computes y = f(x) at
(M, N), then x' = g(y) back at (M, K), so the loop carries the full
activation: no hoisting, real device-memory streaming, the dataflow of the
SAM ViT-H encoder's MLP (K x N = 1280 x 5120). Variants:

  xla_bf16          torch.matmul, bf16 (cuBLAS on the card)
  xla_bf16_gelu     torch.matmul + bias + erf GELU + torch.matmul
  pallas_bf16       ops/serving_matmul.fused_dense (kernel 9)
  pallas_gelu       fused_dense with its bias + GELU epilogue
  xla_int8          the library composition: quantize_int8, torch._int_mm,
                    rescale (a yardstick; the CPU takes the exact float64
                    composition of ops/quant.int8_matmul instead)
  pallas_int8       ops/int8_matmul.int8_matmul_fused (kernel 6)
  pallas_int8_gelu  int8_matmul_fused with its erf GELU epilogue
  pallas_int8_pre   quantize_rows + int8_matmul_prequant (kernels 7 + 8)

Usage: python -m interactvlm_tpu_torch.probes.chain [variant ...]
Env: PROBE_M (rows, default 32768 on the card), PROBE_K / PROBE_N (default
1280 / 5120), PROBE_ITERS (default 20). Runs on the card; ``main(...,
device="cpu")`` runs the plain versions. A variant that fails raises.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from interactvlm_tpu_torch.ops.int8_matmul import (
    int8_matmul_fused,
    int8_matmul_prequant,
    quantize_rows,
)
from interactvlm_tpu_torch.ops.quant import int8_matmul, quantize_int8
from interactvlm_tpu_torch.ops.serving_matmul import fused_dense
from interactvlm_tpu_torch.utils.device import resolve_device, timed

VARIANTS = ("xla_bf16", "xla_bf16_gelu", "pallas_bf16", "pallas_gelu",
            "xla_int8", "pallas_int8", "pallas_int8_gelu", "pallas_int8_pre")
DEFAULT_VARIANTS = VARIANTS[:6]  # the JAX probe's default list
# the hand-written kernels each variant launches, twice an iteration
KERNELS = {"pallas_bf16": (fused_dense,), "pallas_gelu": (fused_dense,),
           "pallas_int8": (int8_matmul_fused,),
           "pallas_int8_gelu": (int8_matmul_fused,),
           "pallas_int8_pre": (quantize_rows, int8_matmul_prequant)}


@dataclass
class ChainWeights:
    """The chain's weights in the port's (out, in) layout: w1 (N, K), w2
    (K, N) bf16, the bias b1 (N,) bf16, and their int8 forms with
    per-output-column scales."""
    w1: torch.Tensor
    w2: torch.Tensor
    b1: torch.Tensor
    w1q: torch.Tensor
    w1s: torch.Tensor
    w2q: torch.Tensor
    w2s: torch.Tensor

    @classmethod
    def from_bf16(cls, w1, w2, b1):
        (w1q, w1s), (w2q, w2s) = (quantize_int8(w.float()) for w in (w1, w2))
        return cls(w1, w2, b1, w1q, w1s[:, 0].contiguous(), w2q,
                   w2s[:, 0].contiguous())


def make_inputs(M, K, N, device, seed=0):
    """x0 (M, K) and weights at the JAX probe's scales (chain_probe.py:52-58):
    unit-variance x, weights N(0, 1/fan_in) so the chain stays alive, a zero
    bias; all drawn from a seeded ``torch.Generator`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(
            torch.bfloat16)

    x0 = draw((M, K))
    w1, w2 = draw((N, K), K ** -0.5), draw((K, N), N ** -0.5)
    b1 = torch.zeros(N, dtype=torch.bfloat16, device=device)
    return x0, ChainWeights.from_bf16(w1, w2, b1)


def _int8_library(x, w_q, w_scale):
    """quantize_int8 -> torch._int_mm -> rescale on the card; the exact
    float64 composition elsewhere."""
    if not x.is_cuda:
        return int8_matmul(x, w_q, w_scale)
    x_q, x_scale = quantize_int8(x)
    return (torch._int_mm(x_q, w_q.t()).float() * x_scale * w_scale).to(
        torch.bfloat16)


def steps(w: ChainWeights) -> Dict[str, Callable]:
    """One chain iteration of each variant: (M, K) bf16 -> (M, K)."""

    def xla_bf16(x):
        return torch.matmul(torch.matmul(x, w.w1.t()), w.w2.t())

    def xla_bf16_gelu(x):
        y = F.gelu(torch.matmul(x, w.w1.t()).float() + w.b1.float())
        return torch.matmul(y.to(torch.bfloat16), w.w2.t())

    def pallas_bf16(x):
        return fused_dense(fused_dense(x, w.w1), w.w2)

    def pallas_gelu(x):
        return fused_dense(fused_dense(x, w.w1, w.b1, "gelu"), w.w2)

    def xla_int8(x):
        return _int8_library(_int8_library(x, w.w1q, w.w1s), w.w2q, w.w2s)

    def pallas_int8(x):
        y = int8_matmul_fused(x, w.w1q, w.w1s)
        return int8_matmul_fused(y, w.w2q, w.w2s)

    def pallas_int8_gelu(x):
        y = int8_matmul_fused(x, w.w1q, w.w1s, activation="gelu")
        return int8_matmul_fused(y, w.w2q, w.w2s)

    def pallas_int8_pre(x):
        y = int8_matmul_prequant(*quantize_rows(x), w.w1q, w.w1s)
        return int8_matmul_prequant(*quantize_rows(y), w.w2q, w.w2s)

    return {f.__name__: f for f in (
        xla_bf16, xla_bf16_gelu, pallas_bf16, pallas_gelu, xla_int8,
        pallas_int8, pallas_int8_gelu, pallas_int8_pre)}


def run_chain(step, x, iters: int):
    for _ in range(iters):
        x = step(x).to(torch.bfloat16)
    return x


def main(argv=None, device="cuda", M=None, K=None, N=None, iters=None):
    """Time each named variant (all eight in ``VARIANTS`` are known); returns
    {variant: {"ms_per_matmul", "tflops", "iters", "launches"}}, the
    launches being each hand-written kernel's count over the timed chain."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    M = M or int(os.environ.get("PROBE_M", "32768" if on_card else "512"))
    K = K or int(os.environ.get("PROBE_K", "1280"))
    N = N or int(os.environ.get("PROBE_N", "5120"))
    iters = iters or int(os.environ.get("PROBE_ITERS", "20"))
    names = list(argv) if argv else list(DEFAULT_VARIANTS)
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        raise ValueError(f"chain: unknown variants {unknown}; known: "
                         f"{VARIANTS}")
    x0, weights = make_inputs(M, K, N, dev)
    fns = steps(weights)
    flops = 2.0 * M * K * N * 2 * iters  # two matmuls an iteration
    where = torch.cuda.get_device_name(dev) if on_card else "cpu (host clock)"
    results = {}
    with torch.inference_mode():
        for name in names:
            run_chain(fns[name], x0, 1)  # warm-up: kernel builds, handles
            kernels = KERNELS.get(name, ())
            before = [k.launches for k in kernels]
            out, dt = timed(lambda: run_chain(fns[name], x0, iters), dev)
            if not bool(torch.isfinite(out).all()):
                raise RuntimeError(f"chain: {name} gave non-finite values")
            results[name] = {
                "ms_per_matmul": dt / (2 * iters) * 1e3,
                "tflops": flops / dt / 1e12, "iters": iters,
                "launches": {k.__name__: k.launches - b
                             for k, b in zip(kernels, before)}}
            print(f"[chain] {name} ({M}x{K}x{N}, {where}): "
                  f"{results[name]['ms_per_matmul']:.3f} ms/matmul  "
                  f"{results[name]['tflops']:.1f} Tflops", flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
