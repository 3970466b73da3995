#!/bin/bash
# The PyTorch/CUDA port's twin of scripts/run_datagen.sh: the same presets,
# flags and argument order, the interactvlm_tpu_torch modules.
# Offline data generation (reference scripts/run_datagen.sh ->
# preprocess_data/generate_* scripts). Each recipe writes the on-disk tree
# the matching dataset class consumes. See
# `python -m interactvlm_tpu_torch.datagen --help` for input formats.
set -e
RECIPE=${1:-damon}
shift || true

python -m interactvlm_tpu_torch.datagen "$RECIPE" "$@"
