#!/bin/bash
# Patient-specific training from scratch, one GPU per subject.
# Reference budget: 30,000 itrs x batch 116 @128^2 (scripts/deepfluoro/train/de_novo.sh).
# Scale-out is orchestration-level: run one subject per host/chip, e.g.
#   for i in 01..06: SUBJECT=subject$i bash de_novo.sh
set -e
SUBJECT=${SUBJECT:-subject01}

xvr-torch train \
    -v data/deepfluoro/$SUBJECT/volume.nii.gz \
    -m data/deepfluoro/$SUBJECT/mask.nii.gz \
    -o models/deepfluoro/de_novo/$SUBJECT \
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
    --batch_size 116 \
    --lr 0.001 \
    --n_total_itrs 30000 \
    --n_save_every_itrs 250 \
    --name deepfluoro-$SUBJECT-de-novo \
    --project xvr
