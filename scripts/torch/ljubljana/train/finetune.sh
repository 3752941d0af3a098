#!/bin/bash
# Finetune the foundation checkpoint to one angio subject: same "5-minute"
# budget as deepfluoro (reference scripts/ljubljana/train/finetune.sh;
# r1 spans -45..105 = frontal AND lateral views in one CNN).
set -e
SUBJECT=${SUBJECT:-subject01}
CKPT=${CKPT:-models/wbct/model.ckpt}

xvr-torch train \
    -v data/ljubljana/$SUBJECT/volume.nii.gz \
    -c $CKPT \
    -w data/ljubljana/$SUBJECT/warp2template.txt \
    -o models/ljubljana/finetuned/$SUBJECT \
    --r1 -45.0 105.0 \
    --r2 -5.0 5.0 \
    --r3 -5.0 5.0 \
    --tx -25.0 25.0 \
    --ty 700.0 800.0 \
    --tz -25.0 25.0 \
    --sdd 1250.0 \
    --height 128 \
    --delx 2.31 \
    --model_name resnet34 \
    --lr 0.001 \
    --p_augmentation 0.333 \
    --batch_size 116 \
    --n_warmup_itrs 10 \
    --n_total_itrs 500 \
    --n_grad_accum_itrs 1 \
    --name ljubljana-$SUBJECT-finetuned \
    --project xvr
