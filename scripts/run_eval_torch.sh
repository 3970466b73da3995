#!/bin/bash
# The PyTorch/CUDA port's twin of scripts/run_eval.sh: the same presets,
# flags and argument order, the interactvlm_tpu_torch modules.
# Evaluation (reference scripts/run_eval.sh): generate-mode validation +
# DAMON reports. Usage: bash scripts/run_eval_torch.sh <run_dir> [args...]
set -e
RUN_DIR=$1; shift
python -m interactvlm_tpu_torch.eval.evaluate --run_dir "$RUN_DIR" "$@"
