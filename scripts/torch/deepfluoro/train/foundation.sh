#!/bin/bash
# Multi-patient "foundation" pretraining: point -v at a directory of CTs
# (reference scripts/v1-submission patient_agnostic pretraining pattern).
set -e
xvr-torch train \
    -v data/deepfluoro_volumes \
    -m data/deepfluoro_masks \
    -o models/deepfluoro/foundation \
    --r1 135.0 225.0 --r2 -45.0 45.0 --r3 -15.0 15.0 \
    --tx -150.0 150.0 --ty 450.0 1000.0 --tz -150.0 150.0 \
    --sdd 1020.0 --height 128 --delx 2.1764375 \
    --model_name resnet34 --batch_size 116 \
    --n_total_itrs 1000000 \
    --name deepfluoro-foundation --project xvr
