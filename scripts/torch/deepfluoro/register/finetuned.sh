#!/bin/bash
# Register every X-ray of a subject with the finetuned model
# (reference scripts/deepfluoro/register/finetuned.sh: scales 24,12,6 x 500,
# full-res 1436^2 detector, crop 100).
set -e
SUBJECT=${SUBJECT:-subject01}

xvr-torch register model \
    data/deepfluoro/$SUBJECT/xrays \
    -v data/deepfluoro/$SUBJECT/volume.nii.gz \
    -m data/deepfluoro/$SUBJECT/mask.nii.gz \
    -c models/deepfluoro/finetuned/$SUBJECT/0001.ckpt \
    -o results/deepfluoro/register/finetuned/$SUBJECT \
    --crop 100 \
    --linearize \
    --labels 1,2,3,4,7 \
    --scales 24,12,6 \
    --n_itrs 500,500,500
