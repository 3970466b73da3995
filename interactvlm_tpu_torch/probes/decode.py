"""Per-component profile of the 7B-int8 decode step: where a decode step's
time goes, at B = 8, Lk = 352 (a 320-token prefill and 32 decode steps).

Port of ``scripts/decode_probe.py``. Variants:

  matmul_floor    every layer's seven projections and the lm_head through
                  the port's serving route, ``Int8Linear`` (kernel 6's
                  one-launch route at 8 rows), nothing else
  attn_int8       the int8-KV attention consumer as ``models/llama.py``
                  formulates it (``_int8_cache_attention``: scale-folded
                  logits and probabilities), with its per-layer mask bias
                  build, over 32 layers
  attn_int8_hoist the same with the (B, 1, 1, Lk) bias built once
  attn_qint8      q quantized per row, so the logits are an int8 x int8
                  product (summed exactly in f32: torch has no batched int8
                  product on the card), no widened copy of the keys
  attn_dense      the bf16 dense-cache formulation
  step_full       one ``decode_step`` of the port's ``LlamaForCausalLM``
                  (int8 weights, int8 cache); also its wall, host-issue and
                  card-busy times

Usage: python -m interactvlm_tpu_torch.probes.decode [variant ...]
(default: all, or those PROBE_WHICH names: floor, attn, qint8, dense,
step). Env: PROBE_B (8), PROBE_LK (352), PROBE_IDX (320), PROBE_ITERS (32).
Each time is the median of 3 windows of PROBE_ITERS steps after one. Runs
on the card; ``main(..., device="cpu")`` runs the plain versions. A
variant that fails or gives non-finite values raises; so does an unknown
one.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from interactvlm_tpu_torch.config import llama_7b
from interactvlm_tpu_torch.models.llama import (
    MASK_BIAS,
    LlamaForCausalLM,
    _int8_cache_attention,
)
from interactvlm_tpu_torch.ops.quant import init_kv_cache_int8, quantize_int8
from interactvlm_tpu_torch.probes.common import (
    check_variants,
    device_busy_ms,
    issue_and_wall_ms,
    launch_counts,
    launches_since,
    require_finite,
)
from interactvlm_tpu_torch.utils.device import resolve_device, timed
from interactvlm_tpu_torch.utils.weights import init_params

VARIANTS = ("matmul_floor", "attn_int8", "attn_int8_hoist", "attn_qint8",
            "attn_dense", "step_full")
WHICH = {"floor": ("matmul_floor",), "attn": ("attn_int8", "attn_int8_hoist"),
         "qint8": ("attn_qint8",), "dense": ("attn_dense",),
         "step": ("step_full",)}


def mask_bias(valid, idx: int):
    """The decode step's (B, 1, 1, Lk) bias: keys past ``idx`` and padded
    slots masked (``models/llama.py``'s formulation)."""
    Lk = valid.shape[1]
    kpos = torch.arange(Lk, device=valid.device)[None, :]
    vis = (kpos <= idx)[None] & (valid[:, None, :] > 0)
    return torch.where(vis, 0.0, MASK_BIAS).to(torch.float32)[:, None]


def matmul_floor(model, x):
    """One step's projections over every layer and the lm_head."""
    for layer in model.model.layers:
        at, mlp = layer.self_attn, layer.mlp
        att = (at.q_proj(x) + at.k_proj(x) + at.v_proj(x)
               + at.o_proj(x))
        x = x + att * 1e-3
        h = F.silu(mlp.gate_proj(x)) * mlp.up_proj(x)
        x = x + mlp.down_proj(h) * 1e-3
    return x + model.lm_head(x).float().mean(-1, keepdim=True).to(
        x.dtype) * 1e-9


def attention_variants(caches, valid, idx, nh):
    """The four attention consumers, each q (B, 1, nh, d) -> q over every
    layer's cache."""
    d = caches[0]["k"].shape[-1]

    def int8(q, hoist):
        bias0 = mask_bias(valid, idx) if hoist else None
        for c in caches:
            bias = bias0 if hoist else mask_bias(valid, idx)
            q = q + _int8_cache_attention(q, c, c["k"].shape[1], bias,
                                          nh) * 1e-3
        return q

    def qint8(q):
        bias = mask_bias(valid, idx)
        for c in caches:
            qq, qs = quantize_int8(q.float())  # (B, 1, nh, d), (B, 1, nh, 1)
            logits = torch.einsum("bqhd,bkhd->bhqk", qq.float(),
                                  c["k"].float())
            logits = (logits * qs[..., 0].permute(0, 2, 1)[..., None]
                      * d ** -0.5)
            logits = logits * c["k_scale"][..., 0].transpose(1, 2)[
                :, :, None, :]
            probs = torch.softmax(logits + bias, dim=-1)
            probs = probs * c["v_scale"][..., 0].transpose(1, 2)[
                :, :, None, :]
            out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype).float(),
                               c["v"].float()).to(q.dtype)
            q = q + out * 1e-3
        return q

    dense = [(c["k"].to(torch.bfloat16) * 0.01, c["v"].to(torch.bfloat16)
              * 0.01) for c in caches]

    def attn_dense(q):
        bias = mask_bias(valid, idx)
        for k, v in dense:
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                  k.float()) * d ** -0.5
            probs = torch.softmax(logits + bias, dim=-1)
            out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype).float(),
                               v.float()).to(q.dtype)
            q = q + out * 1e-3
        return q

    return {"attn_int8": lambda q: int8(q, False),
            "attn_int8_hoist": lambda q: int8(q, True),
            "attn_qint8": qint8, "attn_dense": attn_dense}


def main(argv=None, device="cuda", B=None, Lk=None, idx=None, iters=None,
         config=None):
    """Time each variant; returns {variant: {"ms", "launches"}} (ms a
    step; launches a step), step_full also with ``wall_ms``,
    ``host_issue_ms`` and ``device_busy_ms`` over its window."""
    dev = resolve_device(device)
    B = B or int(os.environ.get("PROBE_B", "8"))
    Lk = Lk or int(os.environ.get("PROBE_LK", "352"))
    idx = idx or int(os.environ.get("PROBE_IDX", "320"))
    iters = iters or int(os.environ.get("PROBE_ITERS", "32"))
    if argv:
        names = list(argv)
    else:
        which = os.environ.get("PROBE_WHICH",
                               "floor,attn,qint8,dense,step").split(",")
        check_variants("decode (PROBE_WHICH)", which, WHICH)
        names = [v for w in which for v in WHICH[w]]
    check_variants("decode", names, VARIANTS)
    cfg = dataclasses.replace(config or llama_7b(), dtype=torch.bfloat16,
                              remat=False, weights_int8=True, lora_rank=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev)
    init_params(model, gen)
    model.requires_grad_(False)
    print(f"[setup] model {time.perf_counter() - t0:.1f}s", flush=True)
    nh, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    valid = torch.from_numpy((np.arange(Lk)[None, :] < idx).astype(
        np.int8).repeat(B, 0)).to(dev)

    def rand_cache():
        caches = init_kv_cache_int8(cfg, B, Lk, dev)
        for c in caches:
            c["k"] = torch.randint(-127, 128, c["k"].shape, generator=gen,
                                   device=dev, dtype=torch.int8)
            c["v"] = torch.randint(-127, 128, c["v"].shape, generator=gen,
                                   device=dev, dtype=torch.int8)
            c["k_scale"] = torch.rand(c["k_scale"].shape, generator=gen,
                                      device=dev) * 0.01
            c["v_scale"] = torch.rand(c["v_scale"].shape, generator=gen,
                                      device=dev) * 0.01
            c["valid"] = valid.clone()
            c["index"] = idx
        return caches

    x0 = torch.from_numpy(rng.normal(size=(B, cfg.hidden_size))).to(
        dev, torch.bfloat16)
    q0 = torch.from_numpy(rng.normal(size=(B, 1, nh, d))).to(
        dev, torch.bfloat16)
    tok0 = torch.from_numpy(rng.integers(
        4, min(30000, cfg.vocab_size), (B, 1))).to(dev)
    pos = torch.full((B, 1), idx, dtype=torch.long, device=dev)
    attn = None
    results = {}
    with torch.inference_mode():
        for name in names:
            if name == "matmul_floor":
                def one(x):
                    return matmul_floor(model, x)
                start = x0
            elif name == "step_full":
                caches = rand_cache()

                def one(tok):
                    logits, _, _ = model.forward_embeds(
                        model.embed(tok), pos, None, caches)
                    for c in caches:  # stay inside the cache
                        c["index"] = min(c["index"], Lk - 1)
                    return logits[:, -1].argmax(-1, keepdim=True)
                start = tok0
            else:
                if attn is None:
                    attn = attention_variants(rand_cache(), valid, idx, nh)
                one, start = attn[name], q0

            def run():
                s = start
                for _ in range(iters):
                    s = one(s)
                return s

            before = launch_counts()
            out = one(start)  # warm-up: builds, a step's launches
            launches = launches_since(before)
            if name == "step_full":
                for c in caches:
                    c["index"] = idx
            ts = []
            for _ in range(3):
                out, dt = timed(run, dev)
                require_finite("decode", name, out.float())
                ts.append(dt / iters * 1e3)
            results[name] = {"ms": float(np.median(ts)), "min_ms": min(ts),
                             "launches": launches}
            extra = ""
            if name == "step_full":
                issue, wall = issue_and_wall_ms(run, dev)
                busy = device_busy_ms(run, dev)
                results[name].update(
                    wall_ms=wall / iters, host_issue_ms=issue / iters,
                    device_busy_ms=None if busy is None else busy / iters)
                extra = (f"  wall {wall / iters:.3f} host-issue "
                         f"{issue / iters:.3f} card-busy "
                         + ("not measured" if busy is None
                            else f"{busy / iters:.3f}") + " ms/step")
            print(f"{name:>18}: {results[name]['ms']:8.3f} ms/step  (min "
                  f"{min(ts):.3f}) launches/step {launches}{extra}",
                  flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
