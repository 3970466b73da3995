"""Deployment export: fold LoRA adapters and save inference weights.

Port of ``interactvlm_tpu/train/export.py`` (a rebuild of the reference's
``merge_lora_weights_and_save_hf_model.py``: zero_to_fp32 -> rebuild ->
merge_and_unload -> save): restores the best training checkpoint (or the
latest), merges the LoRA adapters into the base LLaMA weights, drops the
optimizer state, and writes the merged ``state_dict`` (``params.pt``) and
``pretrained_config.json`` into ``--out_dir``. Runs on the host: it reads
and writes tensors only.

    python -m interactvlm_tpu_torch.train.export --run_dir <run> \
        --out_dir <dir>
"""

from __future__ import annotations

import argparse
import os

import torch


def main(argv=None):
    p = argparse.ArgumentParser("interactvlm_tpu_torch export")
    p.add_argument("--run_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--use_best", action="store_true", default=True)
    args = p.parse_args(argv)

    from interactvlm_tpu_torch.train.checkpoints import (
        CheckpointManager,
        load_config,
        save_config,
    )
    from interactvlm_tpu_torch.train.train import build_config, parse_args
    from interactvlm_tpu_torch.utils.weights import merge_lora

    cfg_json = load_config(args.run_dir, "pretrained_config.json")
    train_args = parse_args([])
    for k, v in cfg_json.items():
        if hasattr(train_args, k):
            setattr(train_args, k, v)

    ckpt = CheckpointManager(args.run_dir)
    state = (
        ckpt.restore_best()
        if args.use_best and os.path.exists(ckpt.best_dir)
        else ckpt.restore()
    )
    if state is None:
        raise FileNotFoundError(f"no checkpoint found in {args.run_dir}")

    sd = state["model"]
    llama = build_config(train_args, device="cpu").llama
    if llama.lora_rank > 0:
        sd = merge_lora(sd, llama.lora_alpha, llama.lora_rank)

    os.makedirs(args.out_dir, exist_ok=True)
    torch.save(sd, os.path.join(args.out_dir, "params.pt"))
    save_config(args.out_dir, cfg_json, "pretrained_config.json")
    print(f"exported merged inference params -> {args.out_dir}")
    return sd


if __name__ == "__main__":
    main()
