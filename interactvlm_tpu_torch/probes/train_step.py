"""Real-shape training-step timing on one card: LoRA rank 8 on q/v,
frozen towers, 4 views of 1024^2 SAM input, 512 spliced tokens, 1024^2
GT masks and the full focal + dice + 3D-lift losses, through
``train/train_step.py:TrainStep``.

Port of ``scripts/train_step_probe.py``. Prints one JSON line: ms a step
(the median of PROBE_REPEATS kept windows of PROBE_STEPS steps, after one
discarded warm-up window), images/s, tokens/s, a training MFU against the
H100's bf16 peak (989 TFLOP/s; the frozen towers' backward counted as
activation gradients only, as the JAX script counts it), and
``utils/memory.py:training_budget`` beside the measured peak.

  PROBE_LLAMA=7b PROBE_B=2 PROBE_ACCUM=4 python -m \
      interactvlm_tpu_torch.probes.train_step

Env: PROBE_LLAMA (7b | 13b | tiny; default 7b, bf16), PROBE_B (2),
PROBE_ACCUM (1: micro-batches a step, ``TrainStep``'s accumulation),
PROBE_VIEWS (4), PROBE_TEXT (257 tokens: +255 spliced = 512), PROBE_MASK
(1024), PROBE_REPEATS (5 on the card, 3 on the CPU), PROBE_STEPS (32 on
the card, 2 on the CPU), PROBE_INT8=1 (QLoRA: a frozen int8 LLaMA base),
PROBE_SAM_INT8=1 (the frozen SAM encoder in the serving int8 layout),
PROBE_LEGS=1 (also time the SAM encode and the loss forward alone,
PROBE_LEG_STEPS each), PROBE_OUT=path (write the record there). Runs on the
card; ``main(device="cpu")`` runs the plain versions (``PROBE_LLAMA=tiny``
for a CPU run). A non-finite loss raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from interactvlm_tpu_torch import config as cfgs
from interactvlm_tpu_torch.probes.common import (
    BF16_PEAK,
    flops_per_image,
    llama_matmul_params,
    peak_gb,
    reset_peak,
)
from interactvlm_tpu_torch.utils.device import resolve_device


def log(*a):
    print("[probe]", *a, file=sys.stderr, flush=True)


def build_config(size: str, int8_base: bool, sam_int8: bool, V: int,
                 on_card: bool):
    """The probe's model: the tiny preset, or LLaMA-7B / 13B bf16 with
    LoRA 8 (alpha 16) on q/v, CLIP ViT-L/14 and SAM ViT-H in bf16."""
    if size == "tiny":
        return cfgs.interactvlm_tiny(
            llama=cfgs.llama_tiny(lora_rank=4, weights_int8=int8_base),
            sam=cfgs.sam_tiny(weights_int8=sam_int8))
    bf16 = torch.bfloat16
    lc = {"7b": cfgs.llama_7b, "13b": cfgs.llama_13b}[size]
    llama = lc(dtype=bf16, lora_rank=8, lora_alpha=16.0,
               weights_int8=int8_base)
    return dataclasses.replace(
        cfgs.interactvlm_13b(), llama=llama,
        clip=cfgs.clip_vit_l_14(dtype=bf16),
        sam=cfgs.sam_vit_h(dtype=bf16, weights_int8=sam_int8,
                           gelu_approx=sam_int8 and on_card),
        seg_token_idx=min(llama.vocab_size - 1, 32000),
        img_emb_len=cfgs.clip_vit_l_14().num_patches - 1,
        multiview_channels=V, out_dim=256)


def main(argv=None, device="cuda"):
    """Returns the printed record. The probe has no variants: any
    ``argv`` raises."""
    from interactvlm_tpu_torch.models.interactvlm import InteractVLM
    from interactvlm_tpu_torch.runtime.hostmem import tune_host_allocator
    from interactvlm_tpu_torch.train.optimizer import (
        cast_frozen_params,
        make_optimizer,
    )
    from interactvlm_tpu_torch.train.train_step import TrainStep
    from interactvlm_tpu_torch.utils.memory import training_budget
    from interactvlm_tpu_torch.utils.testing import make_synthetic_batch
    from interactvlm_tpu_torch.utils.weights import init_params

    if argv:
        raise ValueError(f"train_step: unknown variants {list(argv)}; the "
                         f"probe takes none (set PROBE_* instead)")
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    tune_host_allocator()
    size = os.environ.get("PROBE_LLAMA", "7b")
    B = int(os.environ.get("PROBE_B", "2"))
    accum = int(os.environ.get("PROBE_ACCUM", "1"))
    V = int(os.environ.get("PROBE_VIEWS", "4"))
    L_TEXT = int(os.environ.get("PROBE_TEXT", "257"))
    mask_size = int(os.environ.get("PROBE_MASK", "1024"))
    repeats = int(os.environ.get("PROBE_REPEATS", "5" if on_card else "3"))
    steps_per_window = int(os.environ.get("PROBE_STEPS",
                                          "32" if on_card else "2"))
    int8_base = os.environ.get("PROBE_INT8", "0") == "1"
    sam_int8 = os.environ.get("PROBE_SAM_INT8", "0") == "1"
    if size not in ("7b", "13b", "tiny"):
        raise ValueError(f"train_step: PROBE_LLAMA {size!r} is not one of "
                         f"7b, 13b, tiny")
    cfg = build_config(size, int8_base, sam_int8, V, on_card)
    lcfg = cfg.llama
    Lp = L_TEXT + 255
    bud = training_budget(cfg, batch=B, views=V, seq_len=Lp)
    log(f"{size} LoRA B={B} accum={accum} seq={Lp} "
        f"budget={bud.total / 2**30:.2f} GiB fits={bud.fits()}")

    t0 = time.perf_counter()
    model = InteractVLM(cfg, device=dev)
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    if size != "tiny":
        cast_frozen_params(model, torch.bfloat16)
    opt, sched = make_optimizer(model, lr=3e-4)
    step = TrainStep(model, opt, sched)
    micro = make_synthetic_batch(cfg, B=B, L=L_TEXT, tasks=(2,),
                                 mask_size=mask_size, device=dev)
    batch = [micro] * accum if accum > 1 else micro
    log(f"state init {time.perf_counter() - t0:.1f}s")

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    metrics = step(batch)
    loss = metrics["loss"].item()
    log(f"build+step0 {time.perf_counter() - t0:.1f}s loss={loss:.4f}")
    if not np.isfinite(loss):
        raise RuntimeError(f"train_step: non-finite loss {loss}")
    reset_peak(dev)
    times = []
    for w in range(repeats + 1):  # +1: the discarded warm-up window
        sync()
        t0 = time.perf_counter()
        for _ in range(steps_per_window):
            metrics = step(batch)
        loss = metrics["loss"].item()
        if not np.isfinite(loss):
            raise RuntimeError(f"train_step: non-finite loss {loss}")
        dt = (time.perf_counter() - t0) / steps_per_window
        log(f"window {w}: {dt * 1e3:.1f} ms/step"
            + (" (discarded warmup)" if w == 0 else ""))
        if w > 0:
            times.append(dt)
    peak = peak_gb(dev)
    ms = float(np.median(times)) * 1e3
    eff_b = B * accum

    legs = None
    if os.environ.get("PROBE_LEGS", "0") == "1":
        leg_steps = int(os.environ.get("PROBE_LEG_STEPS",
                                       "8" if on_card else "2"))

        def timed_leg(label, fn):
            fn()
            ts = []
            for _ in range(3):
                sync()
                t0 = time.perf_counter()
                for _ in range(leg_steps):
                    s = fn()
                if not bool(torch.isfinite(s)):
                    raise RuntimeError(f"train_step: leg {label} non-finite")
                ts.append((time.perf_counter() - t0) / leg_steps)
            med = float(np.median(ts)) * 1e3
            log(f"leg {label}: {med:.1f} ms "
                f"[{min(ts) * 1e3:.1f}-{max(ts) * 1e3:.1f}]")
            return round(med, 1)

        with torch.no_grad():
            imgs = torch.as_tensor(micro["sam_images"], device=dev)
            sam_ms = timed_leg("sam_encode_fwd", lambda: (
                model.encode_sam_images(imgs).float().mean()))
            fwd_ms = timed_leg("loss_fwd", lambda: model(micro)["loss"])
        legs = {"sam_encode_fwd_ms": sam_ms, "loss_fwd_ms": fwd_ms,
                "llama_tail_fwd_ms": round(fwd_ms - sam_ms, 1),
                "bwd_update_ms": round(ms / accum - fwd_ms, 1),
                "leg_steps": leg_steps}
        log(f"legs: {legs}")

    # the frozen LLaMA base's backward is activation gradients only (one
    # dx product a forward product), SAM and CLIP forward only; LoRA and
    # head weight gradients ride the 2 % pad
    f_llama = 2 * llama_matmul_params(lcfg) * Lp
    f_total = flops_per_image(cfg, V, Lp, 0)
    f_train = 1.02 * (f_total / 1.02 - f_llama + 2 * f_llama) * eff_b
    mfu = f_train / (ms / 1e3) / BF16_PEAK if size != "tiny" else 0.0
    name = (f"train_step_ms_llama{size}{'-int8base' if int8_base else ''}"
            f"{'-samint8' if sam_int8 else ''}_lora{lcfg.lora_rank}_"
            f"b{B}x{accum}_{V}view_seq{Lp}_mask{mask_size}")
    record = {
        "metric": name, "value": round(ms, 1), "unit": "ms/step",
        "spread_ms": [round(min(times) * 1e3, 1),
                      round(max(times) * 1e3, 1)],
        "images_per_sec": round(eff_b / (ms / 1e3), 3),
        "budget_gib": round(bud.total / 2**30, 2),
        "budget_fits": bud.fits(),
        "peak_gib": None if peak is None else round(peak * 1e9 / 2**30, 2),
        "final_loss": round(loss, 4),
        "steps_per_window": steps_per_window, "n_windows": repeats,
        "batch_size": B, "seq_len": Lp,
        "tokens_per_sec": round(eff_b * Lp / (ms / 1e3), 1),
        "train_mfu": round(mfu, 4),
        "device": (torch.cuda.get_device_name(dev) if on_card
                   else "cpu (host clock)"),
        **({"legs": legs} if legs else {}),
    }
    print(json.dumps(record), flush=True)
    if os.environ.get("PROBE_OUT"):
        with open(os.environ["PROBE_OUT"], "w") as f:
            json.dump(record, f, indent=2)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
