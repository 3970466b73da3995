#!/bin/bash
# The PyTorch/CUDA port's twin of scripts/run_prepare_weights.sh: the same presets,
# flags and argument order, the interactvlm_tpu_torch modules.
# LoRA merge + inference export (reference run_prepare_weights.sh).
set -e
python -m interactvlm_tpu_torch.train.export --run_dir "$1" --out_dir "$2"
