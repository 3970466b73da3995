#!/bin/bash
# The PyTorch/CUDA port's twin of scripts/run_optim.sh: the same presets,
# flags and argument order, the interactvlm_tpu_torch modules.
# Joint human-object fitting (reference scripts/run_optim.sh).
set -e
python -m interactvlm_tpu_torch.fit.data_io --input_path "$1" "${@:2}"
