#!/bin/bash
# Finetune the foundation checkpoint to one femur subject (reference
# scripts/femur/train/finetune.sh; masked volume, wide 75..270 orbit).
set -e
SUBJECT=${SUBJECT:-subject01}
CKPT=${CKPT:-models/wbct/model.ckpt}

xvr-torch train \
    -v data/femur/$SUBJECT/volume.nii.gz \
    -m data/femur/$SUBJECT/mask_all.nii.gz \
    -c $CKPT \
    -w data/femur/$SUBJECT/warp2template.txt \
    -o models/femur/finetuned/$SUBJECT \
    --r1 75.0 270.0 \
    --r2 -20.0 20.0 \
    --r3 -20.0 20.0 \
    --tx -75.0 75.0 \
    --ty 650.0 950.0 \
    --tz 0.0 100.0 \
    --sdd 1150.0 \
    --height 128 \
    --delx 2.31796875 \
    --model_name resnet34 \
    --lr 0.001 \
    --batch_size 116 \
    --n_warmup_itrs 10 \
    --n_total_itrs 500 \
    --n_save_every_itrs 10 \
    --n_grad_accum_itrs 1 \
    --name femur-$SUBJECT-finetuned \
    --project xvr
