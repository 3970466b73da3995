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
- ``bwd``: ``chip_smoke.case_flash_bwd`` alone at the backward kernels'
  three shapes (the LLaMA-13B layer, the SAM decoder's image -> token
  attention and the fusion's image -> LLaVA attention): each kernel's,
  the whole backward's and the forward + backward's time beside SDPA's,
  the kernels' checks; only the flash kernels are built;
- ``matmuls``: the int8 matmul at the 7B-int8 path's decode and lm_head
  shapes (``chip_smoke.INT8_CASES`` up to ``ONE_LAUNCH_MAX_ROWS`` rows) and
  the bf16 serving matmul at the chain probe's, each timed by CUDA events
  (``kernel_ms``) and by the profiler's device time per call
  (``device_ms``), with the timing code here, the same for both sides;
  then the int4 matmul at LLaMA-7B's decode shapes at 8 and 32 rows, by
  device time with the weight warm in the L2 and with weights cycled past
  it, beside kernel 6 on int8 weights and a bf16 ``F.linear`` cycled the
  same way, each summed over a decode step's calls; and the int4 GEMM at
  7B's prefill shapes (2552 rows) beside the int8 GEMM on the same
  quantized rows; only the matmul kernels are built;
- ``serving_int8`` / ``serving_int4``: ``chip_smoke.serving_path_phase``
  for the 7B-int8 or the 7B-int4 path alone;
- ``decode_plans``: the int4 decode kernel at LLaMA-7B's decode shapes at
  8 and 32 rows on every split it can run (cluster sizes 1-8, each with
  as many clusters as the card holds and half that), weights cycled past
  the L2, beside the split its plan picks; a tree without the plan
  (``ops/int4_matmul.py:decode_plan_on_card``) skips it.

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
         "matmuls", "serving_int8", "serving_int4", "bwd", "decode_plans")
ORDER = ("parent", "change", "change", "parent")

# what one run does, in the checkout it starts in
RUN = r'''
import gc, json, sys, torch
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
name = torch.cuda.get_device_name(0)
part = sys.argv[1]
if part in ("matmuls", "decode_plans"):
    c._cuda.build([s for s in c._cuda.SOURCES
                   if "matmul" in s or "gemm" in s or "prequant" in s])
elif part != "bwd":
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
        from interactvlm_tpu_torch.ops import int4_matmul as Q4
        F = torch.nn.functional
        # LLaMA-7B's decode linears: (K, N, calls a decode step)
        shapes = {"q/k/v/o": (4096, 4096, 128), "gate/up": (4096, 11008, 64),
                  "down": (11008, 4096, 32), "lm_head": (4096, 32000, 1)}
        for M in (8, 32):
            step = {"int4": 0.0, "int8": 0.0, "bf16_linear": 0.0}
            for what, (K, N, n) in shapes.items():
                x, packed, cs, rf = c.int4_inputs(gen, M, K, N)
                nxt4 = c._cycled(lambda: (torch.randint(
                    -128, 128, (N, K // 2), generator=gen, device="cuda",
                    dtype=torch.int8), cs, rf), N * K // 2)
                nxt8 = c._cycled(lambda: c.int8_weight(gen, N, K), N * K)
                wb = c.rand_bf16(gen, (N, K))
                nxtb = c._cycled(lambda: c.rand_bf16(gen, (N, K)), 2 * N * K)
                f4 = lambda: Q4.int4_matmul_fused(x, packed, cs, rf)
                rec = {"name": "int4_decode", "shape": f"{what} M={M} K={K} "
                       f"N={N}", "kernel_ms": c.time_ms(f4, 50),
                       "device_ms": dev_ms(f4),
                       "cycled_device_ms": dev_ms(
                           lambda: Q4.int4_matmul_fused(x, *nxt4())),
                       "int8_cycled_device_ms": dev_ms(
                           lambda: Q.int8_matmul_fused(x, *nxt8())),
                       "library_device_ms": dev_ms(lambda: F.linear(x, wb)),
                       "library_cycled_device_ms": dev_ms(
                           lambda: F.linear(x, nxtb()))}
                print(json.dumps(rec), flush=True)
                step["int4"] += n * rec["cycled_device_ms"]
                step["int8"] += n * rec["int8_cycled_device_ms"]
                step["bf16_linear"] += n * rec["library_cycled_device_ms"]
                del nxt4, nxt8, nxtb, wb, x, packed
                torch.cuda.empty_cache()
            print(json.dumps({"name": "int4_decode_step", "shape": f"M={M}",
                              "kernel_ms": None,
                              "device_ms": step}), flush=True)
        for K, N in ((4096, 11008), (11008, 4096), (4096, 4096)):
            M = 2552
            x, packed, cs, rf = c.int4_inputs(gen, M, K, N)
            xq, xs = Q.quantize_rows(x, rf)
            w8, s8 = c.int8_weight(gen, N, K)
            g4 = lambda: Q4.int4_gemm(xq, xs, packed, cs)
            print(json.dumps({
                "name": "int4_gemm", "shape": f"M={M} K={K} N={N}",
                "kernel_ms": c.time_ms(g4, 10), "device_ms": dev_ms(g4, 10),
                "int8_gemm_ms": dev_ms(lambda: Q.int8_gemm(xq, xs, w8, s8),
                                       10),
                "library_device_ms": dev_ms(
                    lambda: Q4.int4_matmul_fused(x, packed, cs, rf), 10)}),
                flush=True)
            del x, packed, xq, xs, w8
            torch.cuda.empty_cache()
elif part == "decode_plans":
    from interactvlm_tpu_torch.ops import int4_matmul as Q4
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = {"q/k/v/o": (4096, 4096), "gate/up": (4096, 11008),
              "down": (11008, 4096), "lm_head": (4096, 32000)}
    with torch.inference_mode():
        for M in (8, 32):
            for what, (K, N) in shapes.items():
                if not hasattr(Q4, "decode_plan_on_card"):
                    break
                x, packed, cs, rf = c.int4_inputs(gen, M, K, N)
                nxt = c._cycled(lambda: (torch.randint(
                    -128, 128, (N, K // 2), generator=gen, device="cuda",
                    dtype=torch.int8), cs, rf), N * K // 2)
                fits = Q4._card_clusters(0, Q4.padded_rows(M), K)
                nch, blocks = -(-(K // 2) // 128), -(-N // 128)
                split_ms = {}
                for cl in range(1, min(8, nch) + 1):
                    for n in sorted({min(blocks, fits[cl - 1]),
                                     min(blocks, fits[cl - 1] // 2)} - {0}):
                        split_ms[f"{cl}x{n}"] = c.device_ms(
                            lambda: Q4.int4_decode(x, *nxt(), torch.bfloat16,
                                                   (cl, n)), 20)[0]
                plan = Q4.decode_plan_on_card(M, N, K, 0)
                print(json.dumps({
                    "name": "int4_decode_plans", "shape": f"{what} M={M} "
                    f"K={K} N={N}", "kernel_ms": None, "plan": plan,
                    "device_ms": split_ms.get(f"{plan[0]}x{plan[1]}"),
                    "clusters_held": fits, "split_device_ms": split_ms}),
                    flush=True)
                del nxt, x, packed
                torch.cuda.empty_cache()
elif part == "bwd":
    lens = c.train_kv_lengths()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for what, args in (
            ("LLaMA-13B training, 1 layer", (c.B, 40, 512, 512, 128, True,
                                             lens)),
            ("SAM decoder image->token", (c.B * c.V, 8, 4096, 9, 16, False,
                                          None)),
            ("fusion image->LLaVA", (c.B * c.V, 8, 4096, 512, 16, False,
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
                "dq_device_ms", "dkv_device_ms", "old_copies_ms",
                "old_copies_device_ms", "plan",
                "port_fwd_bwd_device_ms_by_kernel", "library_fwd_bwd_device_ms",
                "backward_device_ms_by_kernel",
                "dkv_split", "dkv_device_ms_by_kernel", "kernel_ms_per_block",
                "library_ms", "strided",
                "library_device_ms", "cycled_device_ms",
                "int8_cycled_device_ms", "library_cycled_device_ms",
                "split_device_ms",
                "clusters_held", "err_over_limit") if k in rec}
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
