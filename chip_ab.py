"""Same-call A/B of two checkouts of the PyTorch port on one card.

    python3 chip_ab.py PARENT_DIR CHANGE_DIR [part ...]

Runs each part in the order parent, change, change, parent, each run in a
process of its own started in that checkout's directory, so that it imports
that checkout's ``chip_smoke.py`` and package and builds that checkout's
kernels. Parts (all by default):

- ``kernels``: ``chip_smoke.kernel_phase`` and ``probe_kernel_phase``,
  every kernel case of that checkout with its ``kernel_ms``;
- ``serving``: ``chip_smoke.serving_path_phase`` for the 13B bf16 and the
  7B-int8 paths (images/s, legs, decode split, profile);
- ``train``: ``chip_smoke.training_path_phase``, the 13B LoRA step;
- ``bwd_draws``: ``chip_smoke.case_flash_bwd`` at the LLaMA-13B training
  shape on eight draws (generator seeds 0-7), each with the backward
  kernels' distance from their plain version and from the f64 value.

Each run's output goes to ``build/ab/logs/<n>_<side>_<part>.log`` under
the directory it is started in; the script prints one JSON line per run
with the lines that carry its numbers
(kernel cases as name, shape and ``kernel_ms``; the paths' ``main_path``
and ``legs_ms`` lines). Needs one CUDA card; exits non-zero if a run fails.
Compare two versions only within one call of this script: the card and
the host differ between calls.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

PARTS = ("kernels", "serving", "train", "bwd_draws")
ORDER = ("parent", "change", "change", "parent")

# what one run does, in the checkout it starts in
RUN = r'''
import gc, json, sys, torch
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
name = torch.cuda.get_device_name(0)
c._cuda.build()
part = sys.argv[1]
if part == "kernels":
    c.kernel_phase(name)
    c.probe_kernel_phase(name)
elif part == "serving":
    with torch.inference_mode():
        c.serving_path_phase("13b_bf16", c.config_13b(), "dense", c.B)
        c.serving_path_phase("7b_int8", c.config_7b_int8(), "int8",
                             c.B_CACHED_INT8)
elif part == "train":
    c.training_path_phase()
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
                "name", "shape", "route", "kernel_ms", "quantize_ms",
                "gemm_ms", "dq_ms", "dkv_ms", "backward_ms",
                "kernel_ms_per_block", "err_over_limit") if k in rec}
            if "vs_f64" in rec:  # a backward case: each gradient's check
                row["err_over_limit"] = {
                    g: {"plain": rec[g]["err_over_limit"],
                        "f64": {s: rec["vs_f64"][g][s]["err_over_limit"]
                                for s in ("kernel", "plain")}}
                    for g in ("dq", "dk", "dv")}
            out.append(row)
        elif rec.get("phase") in ("main_path", "legs_ms"):
            out.append({k: v for k, v in rec.items() if k != "metrics"})
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
