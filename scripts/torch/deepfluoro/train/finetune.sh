#!/bin/bash
# Finetune a foundation checkpoint to one subject ("5-minute" budget:
# 500 itrs x batch 116 @128^2; reference scripts/deepfluoro/train/finetune.sh).
set -e
SUBJECT=${SUBJECT:-subject01}
CKPT=${CKPT:-models/deepfluoro/foundation}

xvr-torch train \
    -v data/deepfluoro/$SUBJECT/volume.nii.gz \
    -m data/deepfluoro/$SUBJECT/mask.nii.gz \
    -c $CKPT \
    -o models/deepfluoro/finetuned/$SUBJECT \
    --r1 135.0 225.0 \
    --r2 -45.0 45.0 \
    --r3 -15.0 15.0 \
    --tx -150.0 150.0 \
    --ty 450.0 1000.0 \
    --tz -150.0 150.0 \
    --sdd 1020.0 \
    --height 128 \
    --delx 2.1764375 \
    --model_name resnet34 \
    --lr 0.001 \
    --p_augmentation 0.333 \
    --batch_size 116 \
    --n_warmup_itrs 10 \
    --n_total_itrs 500 \
    --n_grad_accum_itrs 1 \
    --name deepfluoro-$SUBJECT-finetuned \
    --project xvr
