"""int4 weight storage for the decode weight-read leg: the 32-layer
LLaMA-7B matmul leg at decode rows (B = 8), int8 against int4 storage,
and the group-128 int4 quantization error.

Port of ``scripts/int4_probe.py``. Each step runs every layer's seven
products (q, k, v, o; gate, up; down) on the (B, 4096) activations,
carried from layer to layer; the variants differ in how the weights are
stored and multiplied:

  int8          int8 weights, kernel 6 (``int8_matmul_fused``: its
                one-launch route at B = 8), the serving int8 path
  int4_native   packed int4 weights read by the int4 kernel
                (``ops/int4_matmul.py:int4_matmul_fused``, the decode
                kernel ``csrc/int4_matmul.cu`` at B = 8) with a unit row factor (the
                JAX variant stores XLA's s4 type and no row factor, which
                torch lacks on the card; the packed bytes stand in)
  int4_grouped  packed int4 weights, one group of 128 input columns a
                product: kernel 7 quantizes the row once, then kernel 8
                (``int8_matmul_prequant``) per group with that group's f32
                column scales, summed in f32 (the accuracy-preserving
                layout)
  int4_grouped_batched  the same scales, all groups in ONE kernel-8
                product: the quantized row laid block-diagonally over
                (G * B, K) rows, the (G, B, N) partials scaled per group
                and summed
  int4_packed   the port's serving route, ``ops/quant.py:int4_matmul``:
                the int4 kernel with the row factor folded into its row
                quantize

The weights are random integers with scales that keep the activations
O(1) through the 32 layers (the leg's work is the serving path's; its
values are not a model's). The error report is the JAX script's, on the
same seeded Gaussian weights: group-128 int4 and per-channel int8 against
f32, relative output RMSE at decode activations.

Usage: python -m interactvlm_tpu_torch.probes.int4 [variant ...]
(default: all five, less those whose gate is "0"). Env: PROBE_B (8),
PROBE_ITERS (64), PROBE_GROUPED, PROBE_GROUPED_BATCHED, PROBE_PACKED (1);
PROBE_OUT=path writes the JSON record there. Runs on the card;
``main(..., device="cpu")`` runs the plain versions. A variant that fails
or gives non-finite values raises; so does an unknown one.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from interactvlm_tpu_torch.config import llama_7b
from interactvlm_tpu_torch.ops.int4_matmul import int4_matmul_fused
from interactvlm_tpu_torch.ops.int8_matmul import (
    int8_matmul_fused,
    int8_matmul_prequant,
    quantize_rows,
)
from interactvlm_tpu_torch.ops.quant import int4_matmul, pack_int4, unpack_int4
from interactvlm_tpu_torch.probes.common import (
    check_variants,
    launch_counts,
    launches_since,
    require_finite,
)
from interactvlm_tpu_torch.utils.device import resolve_device, timed

GROUP = 128
VARIANTS = ("int8", "int4_native", "int4_grouped", "int4_grouped_batched",
            "int4_packed")
GATES = {"int4_grouped": "PROBE_GROUPED",
         "int4_grouped_batched": "PROBE_GROUPED_BATCHED",
         "int4_packed": "PROBE_PACKED"}
# each layer's products: (name, N, K) of the (N, K) weights
PRODUCTS = ("q", "k", "v", "o", "gate", "up", "down")


def shapes(H: int, I: int):
    return {"q": (H, H), "k": (H, H), "v": (H, H), "o": (H, H),
            "gate": (I, H), "up": (I, H), "down": (H, I)}


def quant_error_group128(H: int, B: int):
    """Relative output RMSE of group-128 int4 and of per-channel int8
    against f32 on Gaussian weights at decode activations (the JAX
    script's ``quant_error_group128``, the same draws)."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(H, H)).astype(np.float32) * 0.02
    x = rng.normal(size=(B, H)).astype(np.float32)
    wg = w.reshape(H // GROUP, GROUP, H)
    s = np.abs(wg).max(axis=1, keepdims=True) / 7.0  # int4: [-8, 7]
    q = np.clip(np.round(wg / np.maximum(s, 1e-12)), -8, 7)
    deq = (q * s).reshape(H, H)
    y, yq = x @ w, x @ deq
    err4 = float(np.sqrt(np.mean((y - yq) ** 2)) / np.sqrt(np.mean(y ** 2)))
    s8 = np.abs(w).max(axis=0, keepdims=True) / 127.0
    deq8 = np.clip(np.round(w / np.maximum(s8, 1e-12)), -127, 127) * s8
    err8 = float(np.sqrt(np.mean((y - x @ deq8) ** 2))
                 / np.sqrt(np.mean(y ** 2)))
    return err4, err8


def make_weights(variant, layers, H, I, dev, gen):
    """One variant's weights: per layer, per product, what its ``mm``
    takes."""
    out = []
    for _ in range(layers):
        lw = {}
        for p, (N, K) in shapes(H, I).items():
            if variant == "int8":
                w = torch.randint(-127, 128, (N, K), generator=gen,
                                  device=dev, dtype=torch.int8)
                lw[p] = (w, torch.full((N,), 1 / (127 * K ** 0.5),
                                       device=dev))
                continue
            q = torch.randint(-8, 8, (N, K), generator=gen, device=dev,
                              dtype=torch.int8)
            col = torch.full((N,), 1 / (7 * K ** 0.5), device=dev)
            if variant in ("int4_native", "int4_packed"):
                rf = torch.ones(K, device=dev)
                lw[p] = (pack_int4(q), col, rf)
            else:
                G = K // GROUP
                gs = (torch.rand(G, N, generator=gen, device=dev)
                      * (2 / (7 * K ** 0.5)))
                packed = pack_int4(q) if variant == "int4_grouped_batched" \
                    else torch.stack([pack_int4(q[:, g * GROUP:(g + 1)
                                                  * GROUP])
                                      for g in range(G)])
                lw[p] = (packed, gs)
        out.append(lw)
    return out


def matmul(variant):
    """Variant's product (B, K) bf16 x one weight entry -> (B, N) f32."""

    def int8(x, w):
        return int8_matmul_fused(x, w[0], w[1], out_dtype=torch.float32)

    def int4_native(x, w):
        return int4_matmul_fused(x, *w, out_dtype=torch.float32)

    def int4_packed(x, w):
        return int4_matmul(x, *w, dtype=torch.float32)

    def int4_grouped(x, w):
        packed, gs = w  # (G, N, 64) packed a group, (G, N) scales
        x_q, x_s = quantize_rows(x)
        ones = torch.ones(x.shape[0], 1, device=x.device)
        acc = 0
        for g in range(packed.shape[0]):
            w_g = torch.cat(unpack_int4(packed[g]), 1)
            acc = acc + int8_matmul_prequant(
                x_q[:, g * GROUP:(g + 1) * GROUP].contiguous(), ones, w_g,
                gs[g].contiguous(), dtype=torch.float32)
        return acc * x_s

    def int4_grouped_batched(x, w):
        packed, gs = w  # (N, K/2) packed, (G, N) scales
        B, K = x.shape
        G = K // GROUP
        x_q, x_s = quantize_rows(x)
        eye = torch.eye(G, dtype=torch.int8, device=x.device)
        blocks = (eye[:, None, :, None]
                  * x_q.reshape(1, B, G, GROUP)).reshape(G * B, K)
        part = int8_matmul_prequant(
            blocks, torch.ones(G * B, 1, device=x.device),
            torch.cat(unpack_int4(packed), 1),
            torch.ones(gs.shape[1], device=x.device), dtype=torch.float32)
        return (part.reshape(G, B, -1) * gs[:, None, :]).sum(0) * x_s

    return locals()[variant]


def step(x, weights, mm):
    """One decode step's matmul leg over every layer."""
    for lw in weights:
        a = sum(mm(x, lw[p]) for p in ("q", "k", "v", "o"))
        x = x + (a * 1e-2).to(torch.bfloat16)
        h = F.silu(mm(x, lw["gate"])) * mm(x, lw["up"])
        x = x + (mm(h.to(torch.bfloat16), lw["down"]) * 1e-2).to(
            torch.bfloat16)
    return x


def main(argv=None, device="cuda", B=None, iters=None, H=None, I=None,
         layers=None):
    """Time each variant's leg (median of 3 windows of ``iters`` steps,
    after one); returns the JAX script's record: ``<variant>_ms``,
    ``<variant>_spread``, the speed-ups over int8, the error report, and
    each variant's launches a step under ``launches``."""
    dev = resolve_device(device)
    cfg = llama_7b()
    B = B or int(os.environ.get("PROBE_B", "8"))
    iters = iters or int(os.environ.get("PROBE_ITERS", "64"))
    H = H or cfg.hidden_size
    I = I or cfg.intermediate_size
    layers = layers or cfg.num_layers
    names = list(argv) if argv else [
        v for v in VARIANTS if os.environ.get(GATES.get(v, ""), "1") == "1"]
    check_variants("int4", names, VARIANTS)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu (host clock)")
    print(f"device: {where}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    x0 = torch.randn(B, H, generator=gen, device=dev).to(torch.bfloat16)
    results = {"B": B, "iters": iters, "group": GROUP, "launches": {}}
    with torch.inference_mode():
        for name in names:
            t0 = time.perf_counter()
            weights = make_weights(name, layers, H, I, dev, gen)
            mm = matmul(name)
            before = launch_counts()
            out = step(x0, weights, mm)  # warm-up: builds, a step's launches
            results["launches"][name] = launches_since(before)
            require_finite("int4", name, out)
            ts = []
            for _ in range(3):
                def run():
                    x = x0
                    for _ in range(iters):
                        x = step(x, weights, mm)
                    return x

                out, dt = timed(run, dev)
                require_finite("int4", name, out)
                ts.append(dt / iters * 1e3)
            med = sorted(ts)[1]
            results[f"{name}_ms"], results[f"{name}_spread"] = med, ts
            print(f"{name:14s} {med:8.3f} ms/step  (windows "
                  f"{['%.3f' % t for t in ts]}; setup "
                  f"{time.perf_counter() - t0 - sum(ts) * iters / 1e3:.1f}"
                  f" s) launches/step {results['launches'][name]}",
                  flush=True)
            del weights
    err4, err8 = quant_error_group128(H, B)
    results["rel_rmse_int4_g128"] = err4
    results["rel_rmse_int8_perchan"] = err8
    for k in ("native", "grouped", "grouped_batched", "packed"):
        if f"int4_{k}_ms" in results and "int8_ms" in results:
            results[f"speedup_{k}"] = (results["int8_ms"]
                                       / results[f"int4_{k}_ms"])
    print(json.dumps(results, indent=2), flush=True)
    if os.environ.get("PROBE_OUT"):
        with open(os.environ["PROBE_OUT"], "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
