#!/bin/bash
# Cerebral angiography patient-specific training
# (reference scripts/ljubljana/train/de_novo.sh).
set -e
SUBJECT=${SUBJECT:-subject01}

xvr-torch train \
    -v data/ljubljana/$SUBJECT/volume.nii.gz \
    -o models/ljubljana/de_novo/$SUBJECT \
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
    --batch_size 116 \
    --n_total_itrs 30000 \
    --n_save_every_itrs 250 \
    --name ljubljana-$SUBJECT-de-novo \
    --project xvr
