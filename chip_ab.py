"""Same-call A/B of two checkouts of the PyTorch port on one card.

    python3 chip_ab.py PARENT_DIR CHANGE_DIR [part ...]

Runs each part in the order parent, change, change, parent, each run in a
process of its own started in that checkout's directory, so that it imports
that checkout's ``chip_smoke.py`` and package and builds that checkout's
kernels. Parts (all by default):

- ``kernels``: ``chip_smoke.kernel_phase`` and ``probe_kernel_phase``,
  every kernel case of that checkout with its ``kernel_ms``;
- ``serving``: ``chip_smoke.serving_path_phase`` for the 13B bf16 and the
  7B-int8 paths (images/s, legs, decode split, profile), on the lift maps
  ``chip_smoke.real_lift_maps`` builds;
- ``train``: ``chip_smoke.training_path_phase``, the 13B LoRA step;
- ``train_qlora``: the same for the 7B QLoRA step (with the
  straight-through backward's device time);
- ``bwd_draws``: ``chip_smoke.case_flash_bwd`` at the LLaMA-13B training
  shape on eight draws (generator seeds 0-7), each with the backward
  kernels' distance from their plain version and from the f64 value;
- ``bwd``: ``chip_smoke.case_flash_bwd`` alone at the two training shapes
  of the backward kernels (the LLaMA-13B layer and the SAM decoder's
  image -> token attention): each kernel's, the whole backward's and the
  forward + backward's time beside SDPA's, the kernels' checks; only the
  flash kernels are built;
- ``matmuls``: the int8 matmul at the 7B-int8 path's decode and lm_head
  shapes (``chip_smoke.INT8_CASES`` up to ``ONE_LAUNCH_MAX_ROWS`` rows) and
  the bf16 serving matmul at the chain probe's, each timed by CUDA events
  (``kernel_ms``) and by the profiler's device time per call
  (``device_ms``), with the timing code here, the same for both sides;
- ``serving_int8`` / ``serving_int4``: ``chip_smoke.serving_path_phase``
  for the 7B-int8 or the 7B-int4 path alone.

Each run's output goes to ``build/ab/logs/<n>_<side>_<part>.log`` under
the directory it is started in; the script prints one JSON line per run
with the lines that carry its numbers
(kernel cases as name, shape and ``kernel_ms``; the paths' ``main_path``
and ``legs_ms`` lines; each profiled batch or step's device time, copy
calls and hand-written kernels' device time). Needs one CUDA card; exits non-zero if a run fails.
Compare two versions only within one call of this script: the card and
the host differ between calls.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

PARTS = ("kernels", "serving", "train", "train_qlora", "bwd_draws",
         "matmuls", "serving_int8", "serving_int4", "bwd")
ORDER = ("parent", "change", "change", "parent")

# what one run does, in the checkout it starts in
RUN = r'''
import gc, json, sys, torch
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
name = torch.cuda.get_device_name(0)
part = sys.argv[1]
if part != "bwd":
    c._cuda.build()
if part == "kernels":
    c.kernel_phase(name)
    c.probe_kernel_phase(name)
elif part.startswith(("serving", "train")):
    lift = c.real_lift_maps()
if part.startswith("serving"):
    paths = {"serving": [("13b_bf16", c.config_13b, "dense", c.B),
                         ("7b_int8", c.config_7b_int8, "int8",
                          c.B_CACHED_INT8)],
             "serving_int8": [("7b_int8", c.config_7b_int8, "int8",
                               c.B_CACHED_INT8)],
             "serving_int4": [("7b_int4", c.config_7b_int4, "int8",
                               c.B_CACHED_INT8)]}[part]
    with torch.inference_mode():
        for path, cfg, kv, b_cached in paths:
            c.serving_path_phase(path, cfg(), kv, b_cached, lift)
elif part == "train":
    c.training_path_phase("train_13b_lora", c.config_13b_train(), lift[0])
elif part == "train_qlora":
    c.training_path_phase("train_7b_qlora", c.config_7b_qlora_train(),
                          lift[0])
elif part == "matmuls":
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from interactvlm_tpu_torch.ops import int8_matmul as Q
    from interactvlm_tpu_torch.ops import serving_matmul as SM

    def dev_ms(fn, iters=20):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        return sum(e.time_range.end - e.time_range.start
                   for e in evs) / 1e3 / iters

    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        for what, M, K, N, bias, act, calls in c.INT8_CASES:
            if M > Q.ONE_LAUNCH_MAX_ROWS or calls is None:
                continue
            x = c.rand_bf16(gen, (M, K))
            w, scale = c.int8_weight(gen, N, K)
            f = lambda: Q.int8_matmul_fused(x, w, scale)
            print(json.dumps({"name": "int8_matmul", "shape": what,
                              "kernel_ms": c.time_ms(f, 50),
                              "device_ms": dev_ms(f)}), flush=True)
        M, K, N = c.CHAIN_M, c.CHAIN_K, c.CHAIN_N
        for k, n in ((K, N), (N, K)):
            x = c.rand_bf16(gen, (M, k))
            w = c.rand_bf16(gen, (n, k), k ** -0.5)
            b = c.rand_bf16(gen, (n,), 0.5)
            for bias, act in ((None, "none"), (b, "gelu")):
                f = lambda: SM.fused_dense(x, w, bias, act)
                print(json.dumps({"name": "fused_dense",
                                  "shape": f"M={M} K={k} N={n} {act}",
                                  "kernel_ms": c.time_ms(f, 10),
                                  "device_ms": dev_ms(f, 5)}), flush=True)
elif part == "bwd":
    lens = c.train_kv_lengths()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for what, args in (
            ("LLaMA-13B training, 1 layer", (c.B, 40, 512, 512, 128, True,
                                             lens)),
            ("SAM decoder image->token", (c.B * c.V, 8, 4096, 9, 16, False,
                                          None))):
        r = c.case_flash_bwd(gen, name, what, *args)
        print(json.dumps({"name": "flash_attention_bwd", **r}), flush=True)
elif part == "bwd_draws":
    lens = c.train_kv_lengths()
    for seed in range(8):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        r = c.case_flash_bwd(gen, name, f"training shape, draw {seed}", c.B,
                             40, 512, 512, 128, True, lens)
        print(json.dumps({"name": "flash_attention_bwd", **r}), flush=True)
'''


def summary(lines):
    """The numbers of a run: kernel cases and the paths' main lines."""
    out = []
    for line in lines:
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if not isinstance(rec, dict):
            continue
        if "kernel_ms" in rec or "dq_ms" in rec:
            row = {k: rec.get(k) for k in (
                "name", "shape", "route", "kernel_ms", "device_ms",
                "quantize_ms", "gemm_ms", "int8_gemm_ms", "dq_ms", "dkv_ms",
                "backward_ms", "port_fwd_bwd_ms", "library_fwd_bwd_ms",
                "dkv_split", "dkv_device_ms_by_kernel", "kernel_ms_per_block",
                "library_ms", "strided",
                "library_device_ms", "err_over_limit") if k in rec}
            if "vs_f64" in rec:  # a backward case: each gradient's check
                row["err_over_limit"] = {
                    g: {"plain": rec[g]["err_over_limit"],
                        "f64": {s: rec["vs_f64"][g][s]["err_over_limit"]
                                for s in ("kernel", "plain")}}
                    for g in ("dq", "dk", "dv")}
            out.append(row)
        elif rec.get("phase") in ("main_path", "legs_ms"):
            out.append({k: v for k, v in rec.items() if k != "metrics"})
        elif rec.get("phase") == "profile":  # a profiled batch or step
            out.append({k: rec.get(k) for k in (
                "phase", "path", "mode", "batch_ms", "device_busy_ms",
                "copy_launches", "kernel_device_ms")})
    return out


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    dirs = {"parent": os.path.abspath(argv[0]),
            "change": os.path.abspath(argv[1])}
    parts = argv[2:] or list(PARTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    logdir = os.path.join(os.getcwd(), "build", "ab", "logs")
    os.makedirs(logdir, exist_ok=True)
    failed = False
    n = 0
    for part in parts:
        for side in ORDER:
            n += 1
            proc = subprocess.run([sys.executable, "-c", RUN, part],
                                  cwd=dirs[side], capture_output=True,
                                  text=True)
            log = os.path.join(logdir, f"{n:02d}_{side}_{part}.log")
            with open(log, "w") as f:
                f.write(proc.stdout)
                f.write(proc.stderr)
            print(json.dumps({"run": n, "side": side, "part": part,
                              "rc": proc.returncode,
                              "numbers": summary(proc.stdout.splitlines())}),
                  flush=True)
            failed |= proc.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
