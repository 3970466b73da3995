"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); exits non-zero, and
prints no result, without them. Phases, each of which fails the run:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the three hand-written attention kernels under
   ``interactvlm_tpu_torch/csrc/``, one ``nvcc`` each, all started together;
3. kernels: each kernel against its plain PyTorch version at the shapes the
   13B serving path gives it, bf16 inputs from a seeded generator, with the
   kernel's, the plain version's and one library call's time beside the
   least time the card could take (``bound_ms``);
4. reference: the ``interactvlm_tiny`` pipeline on the card (bf16 SAM,
   window kernel) against the same weights on the CPU in f32;
5. main path: ``interactvlm_13b`` at full width and depth in bf16 with
   seeded random weights, B=8 images x V=4 views, a 64-token prompt, 32
   greedy decode steps, 1024^2 masks and a 6890-vertex lift, through
   ``evaluate_batch`` in streaming and in cached-view mode; images/s, the
   time of each leg, and each kernel's launch count over the run.

The second-to-last line is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from interactvlm_tpu_torch.config import (
    clip_vit_l_14,
    interactvlm_13b,
    interactvlm_tiny,
    sam_tiny,
    sam_vit_h,
)
from interactvlm_tpu_torch.eval.evaluate import evaluate_batch
from interactvlm_tpu_torch.geometry.lift import (
    build_gather_maps,
    lift_multiview_soft_gather,
)
from interactvlm_tpu_torch.models.generate import greedy_generate
from interactvlm_tpu_torch.models.interactvlm import InteractVLM, lift_human
from interactvlm_tpu_torch.ops import _cuda
from interactvlm_tpu_torch.ops import flash_attention as FA
from interactvlm_tpu_torch.ops import sam_attention as SA
from interactvlm_tpu_torch.utils.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from interactvlm_tpu_torch.utils.weights import init_params

# Dense peak rates (NVIDIA data sheets): bf16 tensor-core FLOP/s, HBM bytes/s.
PEAKS = {"H100 SXM": (989e12, 3.35e12), "H100 PCIe": (756e12, 2.0e12)}
# kernel vs plain version, element-wise (see compare)
ATOL, WINDOW_ATOL, RTOL, RMS_TOL, LSE_TOL = 4e-3, 2e-2, 2e-2, 1e-2, 1e-3
B, V, L_TEXT, T, MASK = 8, 4, 64, 32, 1024
REPEATS = 5  # timed batches per mode, after one warm-up batch each
LEG_REPEATS = 3
N_VERTS, MAX_K, BACKGROUND = 6890, 256, 0.7

KERNELS = {
    "flash_attention": dict(
        source="interactvlm_tpu_torch/csrc/flash_attention.cu",
        replaces="interactvlm_tpu/ops/flash_attention.py:43",
        wrapper=FA.flash_forward),
    "window_attention": dict(
        source="interactvlm_tpu_torch/csrc/window_attention.cu",
        replaces="interactvlm_tpu/ops/sam_attention.py:117",
        wrapper=SA.window_attention),
    "rel_attention": dict(
        source="interactvlm_tpu_torch/csrc/rel_attention.cu",
        replaces="interactvlm_tpu/ops/sam_attention.py:39",
        wrapper=SA.rel_attention),
}


def log(*a):
    print(*a, flush=True)


def peaks(name: str):
    return PEAKS["H100 PCIe" if "PCIe" in name else "H100 SXM"]


def bound(flops, nbytes, name):
    flop_s, byte_s = peaks(name)
    t_ops, t_bytes = flops / flop_s * 1e3, nbytes / byte_s * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def issue_ms(fn):
    """Host time until ``fn`` returns, before the card has finished: where
    it is close to the synchronised wall time, the host sets the pace."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return ms


def spread(xs):
    return {"median": float(np.median(xs)), "min": min(xs), "max": max(xs)}


def rand_bf16(gen, shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(
        torch.bfloat16)


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def compare(got, want, lse=None, lse_want=None, atol=ATOL):
    """Kernel output against its plain version. Element-wise, each output
    within atol + RTOL * |plain|: both write bf16 (8 bits, so a rounding
    step of up to 2^-8 of the value) and round the probabilities to bf16
    against a different maximum; atol covers outputs near zero. Over the
    whole output, the RMS error within RMS_TOL of the plain output's RMS,
    which a systematic error of a percent fails even where every element
    passes. The logsumexp is f32 on both sides: LSE_TOL absolute.

    The window kernel takes WINDOW_ATOL: its plain version, like the TPU
    window kernel, rounds the normalised probabilities to bf16, while the
    CUDA kernel rounds them against its running maximum before it
    normalises. Over 196 keys with the rel-pos bias the softmax is peaked,
    so one weight's rounding step times a value of up to ~4 moves an output
    by up to ~2^-6 whatever the output's own size."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    res = {"max_abs_err": err.max().item(),
           "err_over_limit": (err / (atol + RTOL * w.abs())).max().item(),
           "rms_rel_err": (err.square().mean()
                           / w.square().mean().clamp_min(1e-30)).sqrt().item()}
    del g, w, err
    if lse is not None:
        res["lse_abs_err"] = max_err(lse, lse_want)
    res["tol"] = {"atol": atol, "rtol": RTOL, "rms_rel": RMS_TOL,
                  "lse_abs": LSE_TOL}
    res["ok"] = (res["err_over_limit"] <= 1.0 and res["rms_rel_err"] <= RMS_TOL
                 and res.get("lse_abs_err", 0.0) <= LSE_TOL)
    return res


def sdpa():
    # the library yardstick only: the port itself never calls it
    return torch.nn.functional.scaled_dot_product_attention


# --------------------------------------------------------------- kernels
def case_flash_prefill(gen, name):
    """LLaMA-13B prefill, one layer: B=8, H=40, L=319, D=128, causal, with
    the per-row kv lengths of an all-valid prompt."""
    Bq, H, L, D = B, 40, L_TEXT - 1 + 256, 128
    q, k, v = (rand_bf16(gen, (Bq, H, L, D)) for _ in range(3))
    lens = torch.full((Bq,), L, dtype=torch.int32, device="cuda")
    got, lse = FA.flash_forward(q, k, v, True, None, lens)
    want, lse_want = FA.flash_forward_plain(q, k, v, True, None, lens)
    r = torch.arange(L, device="cuda")
    vis = (r[None, :] <= r[:, None])[None] & (r[None, None, :] < lens[:, None, None])
    mask = torch.where(vis, 0.0, float("-inf")).to(torch.bfloat16)[:, None]
    pairs = int(vis.sum().item()) * H
    t, by = bound(4 * D * pairs, (4 * Bq * H * L * D) * 2 + Bq * H * L * 4
                  + Bq * 4, name)
    return dict(
        shape="B=8 H=40 L=319 D=128 causal kv_lengths (LLaMA prefill, 1 layer)",
        **compare(got, want, lse, lse_want),
        kernel_ms=time_ms(lambda: FA.flash_forward(q, k, v, True, None, lens), 20),
        plain_ms=time_ms(
            lambda: FA.flash_forward_plain(q, k, v, True, None, lens), 5),
        library_ms=time_ms(lambda: sdpa()(q, k, v, attn_mask=mask), 20),
        bound_ms=t, bound_by=by)


def case_flash_sam(gen, name):
    """SAM decoder image -> token attention: B*V=32, H=8, Lq=4096, Lk=9,
    D=16, non-causal."""
    R, H, Lq, Lk, D = B * V, 8, 4096, 9, 16
    q = rand_bf16(gen, (R, H, Lq, D))
    k, v = rand_bf16(gen, (R, H, Lk, D)), rand_bf16(gen, (R, H, Lk, D))
    got, lse = FA.flash_forward(q, k, v)
    want, lse_want = FA.flash_forward_plain(q, k, v)
    t, by = bound(4 * R * H * Lq * Lk * D,
                  (2 * R * H * Lq * D + 2 * R * H * Lk * D) * 2
                  + R * H * Lq * 4, name)
    return dict(
        shape="B=32 H=8 Lq=4096 Lk=9 D=16 (SAM decoder image->token)",
        **compare(got, want, lse, lse_want),
        kernel_ms=time_ms(lambda: FA.flash_forward(q, k, v), 20),
        plain_ms=time_ms(lambda: FA.flash_forward_plain(q, k, v), 5),
        library_ms=time_ms(lambda: sdpa()(q, k, v), 20),
        bound_ms=t, bound_by=by)


def case_window(gen, name):
    """ViT-H window block: 32 images x 25 windows x 16 heads = 12 800 rows,
    L=196 (14x14), D=80, stacked factors (R, 28, 196)."""
    R, hw, L, D = B * V * 25 * 16, (14, 14), 196, 80
    q, k, v = (rand_bf16(gen, (R, L, D)) for _ in range(3))
    f = rand_bf16(gen, (R, 28, L), 0.5)
    got = SA.window_attention(q, k, v, f, hw)
    want = SA.window_attention_plain(q, k, v, f, hw)
    c = torch.arange(L, device="cuda")
    bias = (f[:, c // 14, :] + f[:, 14 + c % 14, :]).transpose(1, 2).contiguous()
    t, by = bound(4 * R * L * L * D, 4 * R * L * D * 2 + R * 28 * L * 2, name)
    return dict(
        shape="R=12800 L=196 D=80 (ViT-H window block, all 32 images)",
        **compare(got, want, atol=WINDOW_ATOL),
        kernel_ms=time_ms(lambda: SA.window_attention(q, k, v, f, hw), 10),
        plain_ms=time_ms(lambda: SA.window_attention_plain(q, k, v, f, hw), 3),
        library_ms=time_ms(lambda: sdpa()(q, k, v, attn_mask=bias), 10),
        bound_ms=t, bound_by=by)


def case_global(gen, name):
    """ViT-H global block, one image's 16 heads (L=4096, D=80): the plain
    version over all 512 rows would need ~34 GB of f32 logits. The kernel is
    also timed over all 512 rows of a block (``kernel_ms_per_block``)."""
    hw, L, D = (64, 64), 4096, 80

    def inputs(R):
        q, k, v = (rand_bf16(gen, (R, L, D)) for _ in range(3))
        return q, k, v, rand_bf16(gen, (R, 64, L), 0.5), rand_bf16(
            gen, (R, L, 64), 0.5)

    def flops_bytes(R):
        return 4 * R * L * L * D, 4 * R * L * D * 2 + 2 * R * 64 * L * 2

    q, k, v, rh, rw = inputs(16)
    got = SA.rel_attention(q, k, v, rh, rw, hw)
    want = SA.rel_attention_plain(q, k, v, rh, rw, hw)
    c = torch.arange(L, device="cuda")
    bias = (rh[:, c // 64, :].transpose(1, 2) + rw[:, :, c % 64]).contiguous()
    t, by = bound(*flops_bytes(16), name)
    out = dict(
        shape="R=16 L=4096 D=80 (ViT-H global block, one image)",
        **compare(got, want),
        kernel_ms=time_ms(lambda: SA.rel_attention(q, k, v, rh, rw, hw), 10),
        plain_ms=time_ms(lambda: SA.rel_attention_plain(q, k, v, rh, rw, hw), 3),
        library_ms=time_ms(lambda: sdpa()(q, k, v, attn_mask=bias), 10),
        bound_ms=t, bound_by=by)
    del q, k, v, rh, rw, bias, got, want
    big = inputs(B * V * 16)
    out["kernel_ms_per_block"] = time_ms(lambda: SA.rel_attention(*big, hw), 3, 1)
    out["bound_ms_per_block"] = bound(*flops_bytes(B * V * 16), name)[0]
    return out


def kernel_phase(name):
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {"flash_attention": [case_flash_prefill(gen, name),
                                 case_flash_sam(gen, name)],
             "window_attention": [case_window(gen, name)],
             "rel_attention": [case_global(gen, name)]}
    for kname, rows in cases.items():
        for row in rows:
            log(json.dumps({"name": kname, **row}))
            if not row["ok"]:
                raise SystemExit(f"{kname} disagrees with its plain version "
                                 f"at {row['shape']}: {row}")
    torch.cuda.empty_cache()
    return cases


# --------------------------------------------------------------- models
def synthetic_batch(cfg, batch, prompt_len, device, seed):
    """Random prompt ids with the <image> token at position 1, all-valid
    masks, labels that supervise nothing (the whole prompt is kept), and
    random pixels and camera parameters."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, min(cfg.llama.vocab_size, 30000), (batch, prompt_len))
    ids[:, 1] = IMAGE_TOKEN_INDEX
    gen = torch.Generator(device=device).manual_seed(seed)
    S, C = cfg.sam.img_size, cfg.clip.image_size
    return {
        "input_ids": ids,
        "labels": np.full_like(ids, IGNORE_INDEX),
        "images_clip": torch.randn((batch, C, C, 3), generator=gen,
                                   device=device),
        "sam_images": torch.randn((batch, V, S, S, 3), generator=gen,
                                  device=device, dtype=cfg.sam.dtype),
        "cam_params": torch.randn((batch, V, 5), generator=gen, device=device),
    }


def synthetic_lift_maps(hw, n_verts, device, seed):
    """Corner-major pixel -> vertex maps (3, V, hw, hw) over ``n_verts``
    vertices with a share of background (-1) pixels, and barycentric
    weights that sum to 1 over the three corners."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (3, V, hw, hw)
    p2v = torch.randint(0, n_verts, shape, generator=gen, device=device,
                        dtype=torch.int32)
    bg = torch.rand(shape[1:], generator=gen, device=device) < BACKGROUND
    p2v = torch.where(bg[None], -1, p2v)
    bary = torch.rand(shape, generator=gen, device=device) + 0.05
    return {"p2v": p2v, "bary": bary / bary.sum(0, keepdim=True),
            "num_vertices": n_verts}


def let_seg_token_appear(model, batch, device):
    """Random weights almost never emit [SEG], and without it the mask and
    lift legs return zeros. Make the seg token's lm_head row 1.5x that of
    the token most often emitted, so that it wins wherever that token did."""
    llava, seg = model.llava, model.config.seg_token_idx
    ids = torch.as_tensor(batch["input_ids"], device=device)
    px = torch.as_tensor(batch["images_clip"], device=device).to(
        model.config.clip.dtype)
    out = greedy_generate(llava, ids, px, max_new_tokens=8, eos_id=-1)
    mode = int(torch.mode(out["generated_ids"].flatten()).values)
    with torch.no_grad():
        w = llava.lm.lm_head.weight
        w[seg] = 1.5 * w[mode]


def reference_phase():
    """interactvlm_tiny on the card against the same weights in f32 on the
    CPU, through evaluate_batch. LLaMA and CLIP run f32 on both sides (the
    generated ids must match); SAM runs bf16 on the card (the window kernel
    takes bf16 only), so masks are held to 5e-2 of their largest magnitude
    and contacts to 5e-2 absolute: bf16 keeps ~3 significant digits through
    two encoder blocks, the decoder and the lift's sigmoid."""
    cpu_cfg = interactvlm_tiny()
    gpu_cfg = dataclasses.replace(cpu_cfg, sam=sam_tiny(dtype=torch.bfloat16))
    cpu = init_params(InteractVLM(cpu_cfg, device="cpu"),
                      torch.Generator().manual_seed(1))
    batch = synthetic_batch(cpu_cfg, 2, 12, "cpu", 1)
    batch["sam_images"] = batch["sam_images"].float()
    let_seg_token_appear(cpu, batch, "cpu")
    gpu = InteractVLM(gpu_cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    maps = synthetic_lift_maps(64, cpu_cfg.num_human_vertices, "cpu", 2)
    gpu_batch = {k: torch.as_tensor(x).cuda() if torch.is_tensor(x) else x
                 for k, x in batch.items()}
    gpu_maps = {k: x.cuda() if torch.is_tensor(x) else x
                for k, x in maps.items()}
    before = SA.window_attention.launches
    want = evaluate_batch(cpu, batch, 64, human_maps=maps, eos_id=-1,
                          max_new_tokens=8)
    got = evaluate_batch(gpu, gpu_batch, 64, human_maps=gpu_maps, eos_id=-1,
                         max_new_tokens=8)
    launched = SA.window_attention.launches - before
    ids_equal = torch.equal(got["generated_ids"].cpu(), want["generated_ids"])
    scale = want["pred_masks"].abs().max().item()
    mask_err = max_err(got["pred_masks"].cpu(), want["pred_masks"]) / max(scale, 1e-6)
    contact_err = max_err(got["pred_contact_3d"].cpu(), want["pred_contact_3d"])
    res = dict(phase="reference", config="interactvlm_tiny",
               ids_equal=ids_equal, has_seg=int(want["has_seg"].sum()),
               mask_rel_err=mask_err, contact_abs_err=contact_err,
               window_launches=launched)
    log(json.dumps(res))
    if not (ids_equal and mask_err < 5e-2 and contact_err < 5e-2
            and launched > 0 and bool(want["has_seg"].any())):
        raise SystemExit(f"the card disagrees with the CPU reference: {res}")


def main_path_phase():
    bf16 = torch.bfloat16
    cfg0 = interactvlm_13b()
    cfg = dataclasses.replace(
        cfg0, clip=clip_vit_l_14(dtype=bf16), sam=sam_vit_h(dtype=bf16),
        seg_token_idx=min(cfg0.llama.vocab_size - 1, 32000),
        img_emb_len=clip_vit_l_14().num_patches - 1)
    t0 = time.perf_counter()
    model = InteractVLM(cfg, device="cuda")
    init_params(model, torch.Generator(device="cuda").manual_seed(0))
    model.eval().requires_grad_(False)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(json.dumps({"phase": "init", "params": n_params,
                    "s": time.perf_counter() - t0}))

    batch = synthetic_batch(cfg, B, L_TEXT, "cuda", 0)
    batch["images_clip"] = batch["images_clip"].to(bf16)
    let_seg_token_appear(model, batch, "cuda")
    maps = synthetic_lift_maps(MASK, N_VERTS, "cuda", 3)
    t0 = time.perf_counter()
    gidx, gw = build_gather_maps(maps["p2v"].permute(1, 2, 3, 0).cpu().numpy(),
                                 maps["bary"].permute(1, 2, 3, 0).cpu().numpy(),
                                 N_VERTS, max_k=MAX_K)
    gidx, gw = torch.from_numpy(gidx).cuda(), torch.from_numpy(gw).cuda()
    log(json.dumps({"phase": "gather_maps", "s": time.perf_counter() - t0}))
    # the canonical renders are fixed: cached serving encodes them once
    cached = model.encode_sam_images(batch["sam_images"][:1])

    def run(mode):
        if mode == "cached":
            return evaluate_batch(model, batch, MASK, max_new_tokens=T,
                                  human_maps=maps, eos_id=-1,
                                  cached_image_emb=cached)
        return evaluate_batch(model, batch, MASK, max_new_tokens=T,
                              human_maps=maps, eos_id=-1)

    modes = ("streaming", "cached")
    for mode in modes:  # warm-up: cuBLAS handles, allocator
        run(mode)
    torch.cuda.reset_peak_memory_stats()
    # the first round's batches are the main path's run: their launches are
    # counted and their outputs checked; the later rounds only add times
    outs, secs = {}, {m: [] for m in modes}
    for rnd in range(REPEATS):
        if rnd == 0:
            for w in KERNELS.values():
                w["wrapper"].launches = 0
        for mode in modes:
            out, ms = wall_ms(lambda: run(mode))
            secs[mode].append(ms / 1e3)
            outs.setdefault(mode, out)
        if rnd == 0:
            launches = {n: w["wrapper"].launches for n, w in KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for n, c in launches.items():
        if c <= 0:
            raise SystemExit(f"the main path never launched {n}")

    for mode, out in outs.items():
        masks, contact = out["pred_masks"], out["pred_contact_3d"]
        ok = (tuple(masks.shape) == (B, V, MASK, MASK)
              and tuple(contact.shape) == (B, N_VERTS)
              and bool(torch.isfinite(masks).all())
              and bool(torch.isfinite(contact).all())
              and float(contact.min()) >= 0.0 and float(contact.max()) <= 1.0
              and bool(out["has_seg"].any()))
        med = float(np.median(secs[mode]))
        log(json.dumps({"phase": "main_path", "mode": mode,
                        "images_per_s": B / med,
                        "images_per_s_min": B / max(secs[mode]),
                        "images_per_s_max": B / min(secs[mode]),
                        "batch_s": secs[mode],
                        "has_seg": int(out["has_seg"].sum()),
                        "contact_mean": float(contact.mean()), "ok": ok}))
        if not ok:
            raise SystemExit(f"{mode} outputs are malformed")
    if not torch.equal(outs["streaming"]["generated_ids"],
                       outs["cached"]["generated_ids"]):
        raise SystemExit("streaming and cached runs generated different ids")
    runs = [leg_times(model, batch, maps, gidx, gw, outs["streaming"])
            for _ in range(LEG_REPEATS)]
    legs = {k: spread([r[k] for r in runs]) for k in runs[0]}
    log(json.dumps({"phase": "legs_ms", **legs, "peak_gb": peak_gb}))
    log(json.dumps({"phase": "decode_host_device_ms",
                    **decode_split(model, batch)}))
    log(json.dumps({"phase": "profile", "mode": "streaming",
                    **device_busy(lambda: run("streaming"))}))
    return launches


def device_busy(fn):
    """One batch under torch.profiler: the share of its wall time in which
    the card ran a kernel or copy, and the operations with the most device
    time. The profiler's host-side cost lengthens the batch, so the share is
    a lower bound. ``None`` where the trace holds no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, ms = wall_ms(fn)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:  # the union of the device intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    top = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return {"batch_ms": ms, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e3 / ms if spans else None,
            "top_device_ms": [[e.key[:80], e.self_device_time_total / 1e3,
                               e.count] for e in top]}


def decode_split(model, batch):
    """Where the decode leg's time goes, in one call: the synchronised wall
    time of greedy_generate, the host time until it returns, and the card's
    busy time (torch.profiler); prefill's are subtracted to leave the 31
    decode steps."""
    llava, cfg = model.llava, model.config
    ids = torch.as_tensor(batch["input_ids"], device="cuda")
    px = batch["images_clip"]
    Lp = L_TEXT - 1 + cfg.clip.num_patches

    def prefill():
        return llava.prefill(ids, px, Lp + T)

    def generate():
        return greedy_generate(llava, ids, px, max_new_tokens=T, eos_id=-1)

    walls = {n: wall_ms(f)[1] for n, f in (("p", prefill), ("g", generate))}
    issue = {n: issue_ms(f) for n, f in (("p", prefill), ("g", generate))}
    busy = {n: device_busy(f)["device_busy_ms"]
            for n, f in (("p", prefill), ("g", generate))}
    return {"decode_wall": walls["g"] - walls["p"],
            "decode_host_issue": issue["g"] - issue["p"],
            "decode_device_busy": busy["g"] - busy["p"],
            "generate_wall": walls["g"], "generate_host_issue": issue["g"],
            "generate_device_busy": busy["g"]}


def leg_times(model, batch, maps, gidx, gw, ref):
    """Each leg of one streaming batch, host clock around a synchronised
    call. The gather-form lift (the bench's) is held to the scatter form
    that evaluate_batch runs, 1e-5 absolute: both sum the same f32 terms
    in a different order, and no vertex has more than MAX_K pixels."""
    cfg = model.config
    ids = torch.as_tensor(batch["input_ids"], device="cuda")
    px = batch["images_clip"]
    Lp = L_TEXT - 1 + cfg.clip.num_patches
    llava = model.llava
    _, prefill = wall_ms(lambda: llava.prefill(ids, px, Lp + T))
    gen, generate = wall_ms(
        lambda: greedy_generate(llava, ids, px, max_new_tokens=T, eos_id=-1))
    # the hidden state that predicted each sample's first [SEG]
    is_seg = ref["generated_ids"] == cfg.seg_token_idx
    first = torch.where(ref["has_seg"], is_seg.int().argmax(1), 0)
    h = gen["step_hidden"][torch.arange(B, device="cuda"), first]
    emb, encode = wall_ms(lambda: model.encode_sam_images(batch["sam_images"]))
    cams = batch["cam_params"]

    def tail():
        low = model.low_res_masks_from_image_emb(h, None, emb, cams)
        return model.upsample_masks(low, MASK)

    masks, mask_tail = wall_ms(tail)
    scatter, lift = wall_ms(
        lambda: lift_human(masks, maps["p2v"], maps["bary"], N_VERTS))
    gathered, lift_gather = wall_ms(lambda: torch.stack(
        [lift_multiview_soft_gather(m, gidx, gw) for m in masks]))
    diff = max_err(scatter, gathered)
    if not diff < 1e-5:
        raise SystemExit(f"gather-form lift disagrees with the scatter form: {diff}")
    return {"clip_prefill": prefill, "decode": generate - prefill,
            "sam_encode": encode, "mask_tail": mask_tail, "lift": lift,
            "lift_gather": lift_gather, "lift_gather_vs_scatter": diff}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    name = torch.cuda.get_device_name(0)
    log(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
        f"nvidia-smi: {smi.stderr.strip()}")
    log(json.dumps({"phase": "device", "name": name,
                    "count": torch.cuda.device_count(),
                    "torch": torch.__version__, "cuda": torch.version.cuda}))

    t0 = time.perf_counter()
    reports = _cuda.build()
    regs = {n: [ln.split(":", 1)[1].strip() for ln in r.splitlines()
                if "registers" in ln] for n, r in reports.items()}
    log(json.dumps({"phase": "build", "s": time.perf_counter() - t0,
                    "ptxas": regs}))

    cases = kernel_phase(name)
    with torch.inference_mode():
        reference_phase()
        launches = main_path_phase()

    rows = []
    for kname, meta in KERNELS.items():
        first = cases[kname][0]
        worst = max(cases[kname], key=lambda c: c["err_over_limit"])
        rows.append({
            "name": kname, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[kname],
            "max_abs_err": worst["max_abs_err"],
            "err_over_limit": worst["err_over_limit"], "tol": worst["tol"],
            "ms": first["kernel_ms"],
            **{k: first[k] for k in ("plain_ms", "bound_ms", "bound_by",
                                      "library_ms")},
            "cases": cases[kname],
        })
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
