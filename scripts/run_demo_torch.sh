#!/bin/bash
# The PyTorch/CUDA port's twin of scripts/run_demo.sh: the same presets,
# flags and argument order, the interactvlm_tpu_torch modules.
# Demo (reference scripts/run_demo.sh). Usage:
#   bash scripts/run_demo_torch.sh <img_folder> <out_folder> [hcontact|oafford|...]
set -e
python -m interactvlm_tpu_torch.demo.run_demo \
  --img_folder "$1" --output_folder "$2" --contact_type "${3:-hcontact}" \
  "${@:4}"
