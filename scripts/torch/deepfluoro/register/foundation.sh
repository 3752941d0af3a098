#!/bin/bash
# Register with the multi-subject foundation model, warped into the
# subject's frame; a second pass retries from the antipodal initialization
# (reference scripts/deepfluoro/register/foundation.sh).
set -e
SUBJECT=${SUBJECT:-subject01}
CKPT=${CKPT:-models/wbct/model.ckpt}

xvr-torch register model \
    data/deepfluoro/$SUBJECT/xrays \
    -v data/deepfluoro/$SUBJECT/volume.nii.gz \
    -m data/deepfluoro/$SUBJECT/mask.nii.gz \
    -c $CKPT \
    -o results/deepfluoro/register/foundation/$SUBJECT \
    --crop 100 \
    --linearize \
    --labels 1,2,3,4,7 \
    --scales 24,12,6 \
    --n_itrs 500,500,500 \
    --warp data/deepfluoro/$SUBJECT/warp2template.txt

xvr-torch register model \
    data/deepfluoro/$SUBJECT/xrays \
    -v data/deepfluoro/$SUBJECT/volume.nii.gz \
    -m data/deepfluoro/$SUBJECT/mask.nii.gz \
    -c $CKPT \
    -o results/deepfluoro/register/foundation_antipodal/$SUBJECT \
    --crop 100 \
    --linearize \
    --labels 1,2,3,4,7 \
    --scales 24,12,6 \
    --n_itrs 500,500,500 \
    --warp data/deepfluoro/$SUBJECT/warp2template.txt \
    --antipodal
