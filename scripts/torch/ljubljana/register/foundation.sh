#!/bin/bash
# Register with the foundation model (+antipodal retry), warped into the
# subject frame (reference scripts/ljubljana/register/foundation.sh).
set -e
SUBJECT=${SUBJECT:-subject01}
CKPT=${CKPT:-models/wbct/model.ckpt}

xvr-torch register model \
    data/ljubljana/$SUBJECT/xrays \
    -v data/ljubljana/$SUBJECT/volume.nii.gz \
    -c $CKPT \
    -o results/ljubljana/register/foundation/$SUBJECT \
    --linearize \
    --subtract_background \
    --scales 16,8,4,2 \
    --n_itrs 500,500,500,100 \
    --pattern '*[!_max].dcm' \
    --warp data/ljubljana/$SUBJECT/warp2template.txt

xvr-torch register model \
    data/ljubljana/$SUBJECT/xrays \
    -v data/ljubljana/$SUBJECT/volume.nii.gz \
    -c $CKPT \
    -o results/ljubljana/register/foundation_antipodal/$SUBJECT \
    --linearize \
    --subtract_background \
    --scales 16,8,4,2 \
    --n_itrs 500,500,500,100 \
    --pattern '*[!_max].dcm' \
    --warp data/ljubljana/$SUBJECT/warp2template.txt \
    --antipodal
