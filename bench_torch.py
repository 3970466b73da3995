"""End-to-end generate-path serving throughput of the PyTorch port on one
card: the twin of ``bench.py``.

Times the pipeline ``bench.py`` times (``bench.py:397-454``), in the port:
CLIP ViT-L/14 encode -> image-token spliced LLaMA prefill -> 32-token greedy
decode with a KV cache, keeping each step's hidden state -> the hidden
state at the first [SEG] -> text projection and camera conditioning -> SAM
ViT-H encode of the V = 4 1024^2 views (streaming), or their embedding
encoded once (cached) -> mask decode -> bilinear resize to 1024^2 -> the
gather lift onto the 4722 vertices of ``bench.py``'s sphere, K = 256
pixels a vertex and view (``bench.py``'s lift, not ``evaluate_batch``'s
exact scatter).

    python3 bench_torch.py                     # the card, bench.py's chip defaults
    BENCH_WQ=int4 python3 bench_torch.py       # any BENCH_* knob, as for bench.py
    BENCH_MODE=train python3 bench_torch.py    # the training-step probe

On the card the defaults are ``bench.py``'s chip configuration: LLaMA-7B
with int8 weights and the int8 KV cache, SAM ViT-H with int8 weights and
tanh GELU, CLIP ViT-L/14, bf16, streaming B = 8, cached B = 32, 1024^2
masks. ``main(device="cpu")`` runs ``bench.py``'s CPU configuration (tiny
LLaMA, ``vit_b_small``, tiny CLIP, f32, B = 2, 256^2 masks, the dense
cache) on the kernels' plain versions. Without a card ``main()`` raises: it
never falls back to the CPU.

Knobs (``bench.py:221-290``: the same names, defaults and meaning):
BENCH_LLAMA (7b | 13b | tiny), BENCH_SAM (vit_h | vit_b | vit_b_small |
tiny), BENCH_WQ (int8 | int4 | bf16), BENCH_KV (int8 | dense), BENCH_GELU
(tanh), BENCH_SAM_WQ (int8), BENCH_VIEWS (4), BENCH_BATCH (8; 2 on the CPU),
BENCH_DECODE_TOKENS (32), BENCH_PROMPT (64), BENCH_ITERS (5), BENCH_REPEATS
(3), BENCH_LEGS (1), BENCH_LIFT (lowres | full), BENCH_CACHE_VIEWS (1),
BENCH_CACHE_BATCH (32 at 7B on the card, else B), BENCH_STREAMING (0 at
13B, else 1), BENCH_MODE (serve | train).

The last line of stdout is ``bench.py``'s record, with its keys and their
meaning; ``mfu`` is taken against the H100's dense bf16 peak (989
TFLOP/s), and is 0.0 on the CPU; ``vs_baseline`` keeps ``bench.py``'s A100
estimate. The logs, the card's name and power limit, the lift it times and
the kernels' launches of one streaming and one cached iteration go to
stderr behind ``[bench]``. The script writes no file.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from interactvlm_tpu_torch.config import (
    InteractVLMConfig,
    clip_tiny,
    clip_vit_l_14,
    llama_13b,
    llama_7b,
    llama_tiny,
    sam_tiny,
    sam_vit_b,
    sam_vit_h,
)
from interactvlm_tpu_torch.geometry.lift import lift_multiview_soft_gather
from interactvlm_tpu_torch.models.generate import greedy_generate
from interactvlm_tpu_torch.models.interactvlm import InteractVLM
from interactvlm_tpu_torch.probes.common import (
    BF16_PEAK,
    flops_per_image,
    launch_counts,
    launches_since,
    sphere,
)
from interactvlm_tpu_torch.probes.lift import lift_maps
from interactvlm_tpu_torch.runtime.hostmem import tune_host_allocator
from interactvlm_tpu_torch.utils.constants import IMAGE_TOKEN_INDEX
from interactvlm_tpu_torch.utils.device import resolve_device
from interactvlm_tpu_torch.utils.weights import (
    init_params,
    int4_serving_state_dict,
    int8_sam_encoder_state_dict,
    int8_serving_state_dict,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
# bench.py's A100 estimate of the reference pipeline, images/s (mid, low,
# high; bench.py:82-94): an estimate from public per-component numbers
BASELINE_E2E = {
    "7b": (1.15, 0.9, 1.6),
    "13b": (0.75, 0.6, 1.05),
}
MAX_K = 256  # gathered pixels a vertex and view (bench.py:364-366)
LIFT_NOTE = "gather, K = 256, bench.py's; not evaluate_batch's scatter"
# the stderr line of one iteration's launches, by mode
LAUNCH_LINE = "launches of one {} iteration: "


def log(*a):
    print("[bench]", *a, file=sys.stderr, flush=True)


@dataclasses.dataclass(frozen=True)
class Knobs:
    """``bench.py``'s BENCH_* settings (``bench.py:221-290``)."""

    llama: str
    sam: str
    wq: str
    kv: str
    views: int
    batch: int
    decode_tokens: int
    prompt: int
    iters: int
    repeats: int
    legs: bool
    lift_lowres: bool
    cache_views: bool
    cache_batch: int
    streaming: bool
    gelu_approx: bool
    sam_int8: bool


def read_knobs(on_card: bool, env=os.environ) -> Knobs:
    """The knobs from ``env``, with ``bench.py``'s defaults on the card
    (its TPU defaults) and off it."""
    llama = env.get("BENCH_LLAMA", "7b" if on_card else "tiny")
    batch = int(env.get("BENCH_BATCH", "8" if on_card else "2"))
    # at 13B, cached views only (bench.py:254-262)
    streaming = env.get("BENCH_STREAMING",
                        "0" if llama == "13b" else "1") == "1"
    # the 7B cached batch is 32 on the card (bench.py:246-253)
    cache_batch = 32 if (on_card and llama == "7b") else batch
    return Knobs(
        llama=llama,
        sam=env.get("BENCH_SAM", "vit_h" if on_card else "vit_b_small"),
        wq=env.get("BENCH_WQ", "int8" if on_card else "bf16"),
        kv=env.get("BENCH_KV", "int8" if on_card else "dense"),
        views=int(env.get("BENCH_VIEWS", "4")),
        batch=batch,
        decode_tokens=int(env.get("BENCH_DECODE_TOKENS", "32")),
        prompt=int(env.get("BENCH_PROMPT", "64")),
        iters=int(env.get("BENCH_ITERS", "5")),
        repeats=int(env.get("BENCH_REPEATS", "3")),
        legs=env.get("BENCH_LEGS", "1") == "1",
        lift_lowres=env.get("BENCH_LIFT", "lowres") == "lowres",
        cache_views=(not streaming
                     or env.get("BENCH_CACHE_VIEWS", "1") == "1"),
        cache_batch=int(env.get("BENCH_CACHE_BATCH", str(cache_batch))),
        streaming=streaming,
        gelu_approx=env.get("BENCH_GELU", "tanh") == "tanh" and on_card,
        sam_int8=env.get("BENCH_SAM_WQ", "int8") == "int8" and on_card,
    )


def build_config(k: Knobs, on_card: bool) -> InteractVLMConfig:
    """``bench.py:266-316``'s configuration: bf16 on the card, f32 off it;
    the fields ``bench.py`` sets, the rest ``InteractVLMConfig``'s
    defaults."""
    dtype = torch.bfloat16 if on_card else torch.float32
    wkw = dict(weights_int8=k.wq == "int8", weights_int4=k.wq == "int4")
    if k.llama == "13b":
        lcfg = llama_13b(dtype=dtype, remat=False, **wkw)
    elif k.llama == "7b":
        lcfg = llama_7b(dtype=dtype, remat=False, **wkw)
    else:
        lcfg = llama_tiny(dtype=dtype, **wkw)
    if k.sam == "vit_h":
        scfg = sam_vit_h(dtype=dtype, gelu_approx=k.gelu_approx,
                         weights_int8=k.sam_int8)
    elif k.sam == "vit_b":
        scfg = sam_vit_b(dtype=dtype, gelu_approx=k.gelu_approx,
                         weights_int8=k.sam_int8)
    else:  # vit_b_small, bench.py's CPU configuration
        scfg = dataclasses.replace(
            sam_vit_b(dtype=dtype), img_size=256, encoder_depth=2,
            encoder_global_attn_indexes=(1,))
    full = k.llama in ("7b", "13b")
    ccfg = clip_vit_l_14(dtype=dtype) if full else clip_tiny(dtype=dtype)
    if not full and k.sam == "tiny":
        scfg = sam_tiny(dtype=dtype)
    return InteractVLMConfig(
        llama=lcfg, clip=ccfg, sam=scfg,
        seg_token_idx=min(lcfg.vocab_size - 1, 32000),
        img_emb_len=ccfg.num_patches - 1,
        multiview_channels=k.views,
        out_dim=scfg.prompt_embed_dim,
    )


def build_model(cfg: InteractVLMConfig, dev, seed: int = 0) -> InteractVLM:
    """The model with seeded random weights (``init_params``, a generator
    on ``dev``) drawn in the compute dtype and put in ``cfg``'s serving
    layout: the LLaMA's linears through ``int8_serving_state_dict`` or
    ``int4_serving_state_dict``, the SAM encoder's through
    ``int8_sam_encoder_state_dict``. Frozen, in eval mode."""
    lc, sc = cfg.llama, cfg.sam
    dense = dataclasses.replace(
        cfg, llama=dataclasses.replace(lc, weights_int8=False,
                                       weights_int4=False),
        sam=dataclasses.replace(sc, weights_int8=False))
    model = InteractVLM(dense, device=dev)
    init_params(model, torch.Generator(device=dev).manual_seed(seed))
    if dense != cfg:
        sd = model.state_dict()
        del model
        layouts = (
            ("llava.lm.", int8_serving_state_dict if lc.weights_int8
             else int4_serving_state_dict if lc.weights_int4 else None),
            ("sam.image_encoder.",
             int8_sam_encoder_state_dict if sc.weights_int8 else None))
        for prefix, convert in layouts:
            if convert is not None:
                part = {n: sd.pop(n) for n in list(sd)
                        if n.startswith(prefix)}
                sd.update(convert(part))
        model = InteractVLM(cfg, device=dev)
        model.load_state_dict(sd)
        del sd
    return model.eval().requires_grad_(False)


def e2e(model: InteractVLM, ids, attn_mask, clip_px, view_input, cams,
        gidx, gw, *, cached: bool, T: int, kv_cache: str, mask_size: int,
        lift_lowres: bool):
    """``bench.py:397-454`` in the port: greedy decode of T tokens (no
    EOS), the step hidden state at each row's first [SEG] over the
    generated ids (argmax: step 0 where none), the low-res mask tail from
    the pixels (streaming) or from the view embedding (``cached``:
    (1|B, V, g, g, C)), the masks to ``mask_size`` (``lift_lowres``:
    ``F.interpolate`` bilinear, half-pixel centres, which equals
    ``jax.image.resize`` where it upsamples; else ``upsample_masks``),
    then the gather lift row by row. Returns (the lifted contacts (B, N)
    plus the generated ids' sum times 1e-12, the low-res logits)."""
    seg_idx = model.config.seg_token_idx
    gen = greedy_generate(model.llava, ids, clip_px, max_new_tokens=T,
                          eos_id=-1, attn_mask=attn_mask, kv_cache=kv_cache)
    gen_ids = gen["generated_ids"]
    first = (gen_ids == seg_idx).to(torch.int32).argmax(dim=1)
    rows = torch.arange(ids.shape[0], device=ids.device)
    seg_hidden = gen["step_hidden"][rows, first].to(model.config.sam.dtype)
    token_id = torch.full((ids.shape[0],), seg_idx, dtype=torch.int32,
                          device=ids.device)
    tail = (model.low_res_masks_from_image_emb if cached
            else model.low_res_masks_from_seg_hidden)
    low = tail(seg_hidden, token_id, view_input, cams)
    if lift_lowres:
        masks = F.interpolate(low, size=(mask_size, mask_size),
                              mode="bilinear", align_corners=False)
    else:
        masks = model.upsample_masks(low, mask_size)
    lifted = torch.stack([lift_multiview_soft_gather(m, gidx, gw)
                          for m in masks])
    return lifted + (gen_ids.sum() * 1e-12).to(lifted.dtype), low


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _window(step, iters, acc):
    for _ in range(iters):
        acc = step(acc)
    return acc


def time_windows(step, iters: int, repeats: int, dev, label: str):
    """``bench.py:478-493``: one warm-up window, then ``max(repeats, 1)``
    timed windows of ``iters`` iterations on the host clock, each ended by
    a synchronise. ``step`` maps the carry (last mean, running sum) to the
    next. Returns (median, min, max) seconds an iteration and the kernels'
    launches in the warm-up's first iteration."""
    zero = torch.zeros((), device=dev)
    t0 = time.perf_counter()
    before = launch_counts()
    acc = step((zero, zero))
    launches = launches_since(before)
    acc = _window(step, iters - 1, acc)
    _sync(dev)
    float(acc[0])
    log(f"{label} compile+warmup {time.perf_counter() - t0:.1f}s")
    times = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        acc = _window(step, iters, (zero, zero))
        _sync(dev)
        if not math.isfinite(float(acc[0])):
            raise RuntimeError(f"{label}: the lifted contacts are not finite")
        times.append((time.perf_counter() - t0) / iters)
    return float(np.median(times)), min(times), max(times), launches


def time_leg(fn, iters: int, dev) -> float:
    """``bench.py:542-559``: ``iters`` chained calls of ``fn`` (carry in,
    a scalar out), one warm-up, then the best of two; ms a call."""
    def looped():
        acc = torch.zeros((), device=dev)
        for _ in range(iters):
            acc = fn(acc).float()
        return acc

    float(looped())
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        out = looped()
        _sync(dev)
        float(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best * 1e3


def card_line(dev) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    if dev.type != "cuda":
        return "cpu: the kernels' plain versions; no card times"
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    lines = res.stdout.strip().splitlines()
    return lines[0] if lines else f"nvidia-smi: {res.stderr.strip()}"


def train_mode() -> int:
    """``bench.py:166-183``: the 7B QLoRA training-step probe in a
    subprocess (its defaults set where the caller set none); its exit
    code. Unlike ``bench.py`` it sets no PROBE_OUT: the probe writes a
    record only where the caller asks for one."""
    env = dict(os.environ)
    env.setdefault("PROBE_LLAMA", "7b")
    env.setdefault("PROBE_INT8", "1")  # QLoRA: the one-card 7B step
    env.setdefault("PROBE_B", os.environ.get("BENCH_BATCH", "2"))
    return subprocess.call(
        [sys.executable, "-m", "interactvlm_tpu_torch.probes.train_step"],
        env=env, cwd=ROOT)


def main(device="cuda") -> int:
    """Serve (or, with BENCH_MODE=train, delegate to the training-step
    probe); prints the record last on stdout. 0 on success."""
    if os.environ.get("BENCH_MODE", "serve") == "train":
        return train_mode()
    dev = resolve_device(device)
    tune_host_allocator()
    with torch.inference_mode():
        record = serve(read_knobs(dev.type == "cuda"), dev)
    print(json.dumps(record), flush=True)
    return 0


def serve(k: Knobs, dev) -> dict:
    """``bench.py:185-709`` for the knobs ``k`` on ``dev``: the record."""
    on_card = dev.type == "cuda"
    cfg = build_config(k, on_card)
    lcfg, ccfg, scfg = cfg.llama, cfg.clip, cfg.sam
    dtype = lcfg.dtype
    V, B, T, L_TEXT, iters = (k.views, k.batch, k.decode_tokens, k.prompt,
                              k.iters)
    Bc = k.cache_batch
    seg_idx = cfg.seg_token_idx
    mask_size = 1024 if on_card else 256
    Lp = L_TEXT - 1 + ccfg.num_patches
    log(card_line(dev))
    log(f"lift: {LIFT_NOTE}")

    # inputs as bench.py:326-339 makes them: ids and cams from the numpy
    # generator, the pixels from a seeded generator on the device
    rng = np.random.default_rng(0)
    ids_np = rng.integers(4, min(lcfg.vocab_size, 30000), (B, L_TEXT))
    ids_np[:, 1] = IMAGE_TOKEN_INDEX
    ids = torch.as_tensor(ids_np, dtype=torch.long, device=dev)
    attn_mask = torch.ones((B, L_TEXT), dtype=torch.int32, device=dev)
    cams = torch.as_tensor(rng.normal(size=(V, 5)), dtype=torch.float32,
                           device=dev).expand(B, V, 5)
    gen = torch.Generator(device=dev).manual_seed(0)
    clip_px = torch.randn((B, ccfg.image_size, ccfg.image_size, 3),
                          generator=gen, device=dev, dtype=dtype)
    sam_px = torch.randn((B, V, scfg.img_size, scfg.img_size, 3),
                         generator=gen, device=dev, dtype=dtype)

    # bench.py's sphere under the first V 4MV-Z_Vitru_mv2 cameras,
    # rasterized on the device, in gather form (bench.py:345-369)
    t0 = time.perf_counter()
    _, _, gidx, gw, _ = lift_maps(mask_size, dev, mesh=sphere(),
                                  max_k=MAX_K, views=V)
    log(f"lift maps {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    model = build_model(cfg, dev)
    _sync(dev)
    log(f"inits {time.perf_counter() - t0:.1f}s (seeded weights, "
        f"serving layout)")

    def make_step(ids, attn_mask, clip_px, view_input, cams, cached):
        def step(acc):
            # every leg's input depends on the previous iteration
            # (bench.py:459-470); the cached embedding is constant by design
            d = acc[0].to(dtype) * 1e-6
            vi = view_input if cached else view_input + d
            lifted, _ = e2e(model, ids, attn_mask, clip_px + d, vi, cams,
                            gidx, gw, cached=cached, T=T, kv_cache=k.kv,
                            mask_size=mask_size, lift_lowres=k.lift_lowres)
            return lifted.mean().float(), acc[1] + lifted.sum().float()

        return step

    images_per_sec = dt = spread = None
    if k.streaming:
        dt, dt_min, dt_max, launches = time_windows(
            make_step(ids, attn_mask, clip_px, sam_px, cams, False), iters,
            k.repeats, dev, "e2e")
        log(LAUNCH_LINE.format("streaming") + json.dumps(launches))
        images_per_sec = B / dt
        spread = [round(B / dt_max, 4), round(B / dt_min, 4)]

    cached_ips = cached_spread = cdt = None
    if k.cache_views:
        # the canonical view-set encoded once (bench.py:507-520)
        t0 = time.perf_counter()
        view_emb = model.encode_sam_images(sam_px[:1])
        _sync(dev)
        float(view_emb[0, 0, 0, 0, 0])
        log(f"view-set encode-once {time.perf_counter() - t0:.1f}s "
            f"(amortized across the whole serving run)")
        if Bc != B:
            reps = (Bc + B - 1) // B

            def tile(x):
                return torch.cat([x] * reps, dim=0)[:Bc]

            cached_in = (tile(ids), tile(attn_mask), tile(clip_px))
            cams_c = tile(cams)
        else:
            cached_in, cams_c = (ids, attn_mask, clip_px), cams
        cdt, cdt_min, cdt_max, launches = time_windows(
            make_step(*cached_in, view_emb, cams_c, True), iters, k.repeats,
            dev, "e2e-cached")
        log(LAUNCH_LINE.format("cached") + json.dumps(launches))
        cached_ips = Bc / cdt
        cached_spread = [round(Bc / cdt_max, 4), round(Bc / cdt_min, 4)]

    if k.legs:
        legs(k, model, dev, ids, attn_mask, clip_px, sam_px, cams, gidx, gw,
             mask_size, view_emb if k.cache_views else None, dt, cdt)

    flops = flops_per_image(cfg, V, Lp, T)
    base_mid, base_lo, base_hi = BASELINE_E2E.get(k.llama,
                                                  BASELINE_E2E["7b"])
    record = {
        "metric": (f"e2e_evaluate_images_per_sec_llama{k.llama}-{k.wq}_"
                   f"{k.sam}{'-int8' if k.sam_int8 else ''}_"
                   f"{V}view_b{B}_t{T}"
                   + (f"_cachedviews_b{Bc}" if cached_ips is not None
                      else "")),
        "unit": "images/sec",
        "kv_cache": k.kv,
        "flops_per_image": flops,
    }
    if images_per_sec is not None:
        mfu = images_per_sec * flops / BF16_PEAK if on_card else 0.0
        record.update({
            "uncached_value": round(images_per_sec, 4),
            "uncached_spread": spread,
            "uncached_vs_baseline": round(images_per_sec / base_mid, 4),
            "uncached_mfu": round(mfu, 4),
        })
    if cached_ips is not None:
        flops_c = flops_per_image(cfg, V, Lp, T, include_sam=False)
        mfu_c = cached_ips * flops_c / BF16_PEAK if on_card else 0.0
        record.update({
            "value": round(cached_ips, 4),
            "value_spread": cached_spread,
            "vs_baseline": round(cached_ips / base_mid, 4),
            "vs_baseline_range": [round(cached_ips / base_hi, 4),
                                  round(cached_ips / base_lo, 4)],
            "mfu": round(mfu_c, 4),
            "flops_per_image_cached": flops_c,
            "cache_batch": Bc,
        })
    else:
        record.update({
            "value": round(images_per_sec, 4),
            "value_spread": spread,
            "vs_baseline": round(images_per_sec / base_mid, 4),
            "vs_baseline_range": [round(images_per_sec / base_hi, 4),
                                  round(images_per_sec / base_lo, 4)],
            "mfu": round(mfu, 4),
        })
    return record


def legs(k, model, dev, ids, attn_mask, clip_px, sam_px, cams, gidx, gw,
         mask_size, view_emb, dt, cdt):
    """``bench.py:538-658``: each leg as its own chain of ``iters`` calls
    (``time_leg``), logged on one line."""
    cfg = model.config
    dtype, B, T, iters = cfg.llama.dtype, k.batch, k.decode_tokens, k.iters

    def gen_leg(T_):
        def leg(acc):
            g = greedy_generate(model.llava, ids,
                                clip_px + acc.to(dtype) * 1e-6,
                                max_new_tokens=T_, eos_id=-1,
                                attn_mask=attn_mask, kv_cache=k.kv)
            return (g["step_hidden"].mean()
                    + g["generated_ids"].sum() * 1e-12)

        return leg

    def sam_leg(acc):
        return model.encode_sam_images(sam_px + acc.to(dtype) * 1e-6).mean()

    seg_hidden = torch.zeros((B, cfg.llama.hidden_size), dtype=dtype,
                             device=dev)
    token_id = torch.full((B,), cfg.seg_token_idx, dtype=torch.int32,
                          device=dev)

    def tail_leg(acc):
        # perturb the pixels too, as bench.py does (:584-601)
        d = acc.to(dtype) * 1e-6
        if k.lift_lowres:
            masks = model.low_res_masks_from_seg_hidden(
                seg_hidden + d, token_id, sam_px + d, cams)
        else:
            masks = model.masks_from_seg_hidden(
                seg_hidden + d, token_id, sam_px + d, cams, mask_size)
        return masks.mean()

    low_hw = cfg.sam.image_embedding_size * 4
    leg_mask = low_hw if k.lift_lowres else mask_size
    masks_b = torch.zeros((B, k.views, leg_mask, leg_mask),
                          dtype=torch.float32, device=dev)

    def lift_leg(acc):
        masks = masks_b + acc.to(masks_b.dtype) * 1e-6
        if k.lift_lowres:
            masks = F.interpolate(masks, size=(mask_size, mask_size),
                                  mode="bilinear", align_corners=False)
        return torch.stack([lift_multiview_soft_gather(m, gidx, gw)
                            for m in masks]).mean()

    t_gen1 = time_leg(gen_leg(1), iters, dev)
    t_genT = time_leg(gen_leg(T), iters, dev)
    if k.streaming:
        t_sam = time_leg(sam_leg, iters, dev)
        t_tail = time_leg(tail_leg, iters, dev)
        t_lift = time_leg(lift_leg, iters, dev)
        log(f"legs(ms/batch of {B}): clip+prefill={t_gen1:.0f} "
            f"decode({T}t)={t_genT - t_gen1:.0f} sam_encode={t_sam:.0f} "
            f"mask_decode_tail={t_tail - t_sam:.0f} lift={t_lift:.0f} "
            f"legs_total={t_genT + t_tail + t_lift:.0f} "
            f"e2e={dt * 1e3:.0f}")
    else:
        # cached views only: the tail from the embedding encoded once
        def cached_tail_leg(acc):
            return model.low_res_masks_from_image_emb(
                seg_hidden + acc.to(dtype) * 1e-6, token_id, view_emb,
                cams).mean()

        t_tail = time_leg(cached_tail_leg, iters, dev)
        t_lift = time_leg(lift_leg, iters, dev)
        log(f"legs(ms/batch of {B}, cached views): "
            f"clip+prefill={t_gen1:.0f} "
            f"decode({T}t)={t_genT - t_gen1:.0f} "
            f"mask_decode_tail={t_tail:.0f} lift={t_lift:.0f} "
            f"legs_total={t_genT + t_tail + t_lift:.0f} "
            f"e2e-cached={cdt * 1e3:.0f}")


if __name__ == "__main__":
    sys.exit(main())
