#!/bin/bash
# Register with a de-novo (patient-specific) model
# (reference scripts/deepfluoro/register/de_novo.sh: crop 100, linearize,
# labels 1,2,3,4,7, pyramid 24,12,6 x 500).
set -e
SUBJECT=${SUBJECT:-subject01}
CKPT=${CKPT:-models/deepfluoro/de_novo/$SUBJECT}

xvr-torch register model \
    data/deepfluoro/$SUBJECT/xrays \
    -v data/deepfluoro/$SUBJECT/volume.nii.gz \
    -m data/deepfluoro/$SUBJECT/mask.nii.gz \
    -c $CKPT \
    -o results/deepfluoro/register/de_novo/$SUBJECT \
    --crop 100 \
    --linearize \
    --labels 1,2,3,4,7 \
    --scales 24,12,6 \
    --n_itrs 500,500,500
