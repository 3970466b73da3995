#!/bin/bash
# The PyTorch/CUDA port's twin of scripts/run_train.sh: the same presets,
# flags and argument order, the interactvlm_tpu_torch modules.
# Training presets (parity with the reference scripts/run_train.sh named
# configs). Usage: bash scripts/run_train_torch.sh <preset> [extra args...]
set -e
PRESET=${1:-hcontact-damon}
shift || true

case $PRESET in
  hcontact-damon)
    # reference run_train.sh hcontact config: 30 epochs x 500 steps, bs 8,
    # lr 3e-4, parts template (FIX.md release settings)
    python -m interactvlm_tpu_torch.train.train \
      --exp_name interactvlm-3d-hcontact-damon \
      --dataset hcontact --sample_rates 1 \
      --hC_question_type parts --token_type Gen \
      --epochs 30 --steps_per_epoch 500 --batch_size 8 \
      --lr 3e-4 --warmup_steps 100 "$@"
    ;;
  hcontact-wScene)
    python -m interactvlm_tpu_torch.train.train \
      --exp_name interactvlm-3d-hcontact-wscene \
      --dataset "hcontact||hcontact_scene" --sample_rates 9,3 \
      --hC_sam_view_type 4MV-Z_Vitru_FootGround \
      --epochs 30 --steps_per_epoch 500 --batch_size 8 "$@"
    ;;
  oafford-lemon-piad)
    python -m interactvlm_tpu_torch.train.train \
      --exp_name interactvlm-3d-oafford-lemon-piad \
      --dataset oafford --sample_rates 1 \
      --oC_sam_view_type 4MV-Z_HM \
      --epochs 30 --steps_per_epoch 500 --batch_size 8 "$@"
    ;;
  hcontact-ocontact)
    # the Gen-Hu-Obj interaction flagship (reference run_train.sh:165-199):
    # mixed human-contact + object-contact + affordance + VQA training with
    # [HSEG]/[OSEG] tokens, vi_v1 cam conditioning, low-poly-mesh object
    # views, hC/oC loss weights 3.0
    python -m interactvlm_tpu_torch.train.train \
      --exp_name interactvlm-3d-hcontact-ocontact \
      --dataset "hcontact||ocontact||oafford||vqa" --sample_rates 9,9,5,2 \
      --token_type Gen-Hu-Obj --cam_encoder_type vi_v1 \
      --oC_sam_view_type 4MV-Z_HM_BM --hC_sam_view_type 4MV-Z_Vitru \
      --hC_question_type parts --oC_question_type afford \
      --hC_loss_weight 3.0 --oC_loss_weight 3.0 \
      --epochs 30 --steps_per_epoch 500 --batch_size 8 \
      --lr 3e-4 --warmup_steps 100 "$@"
    ;;
  synthetic-smoke)
    python -m interactvlm_tpu_torch.train.train --synthetic \
      --epochs 1 --steps_per_epoch 5 --batch_size 2 "$@"
    ;;
  *)
    echo "unknown preset: $PRESET"; exit 1;;
esac
