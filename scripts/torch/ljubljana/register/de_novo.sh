#!/bin/bash
# Register cerebral angiograms with a de-novo model (reference
# scripts/ljubljana/register/de_novo.sh: pyramid 16,8,4,2).
set -e
SUBJECT=${SUBJECT:-subject01}
CKPT=${CKPT:-models/ljubljana/de_novo/$SUBJECT}

xvr-torch register model \
    data/ljubljana/$SUBJECT/xrays \
    -v data/ljubljana/$SUBJECT/volume.nii.gz \
    -c $CKPT \
    -o results/ljubljana/register/de_novo/$SUBJECT \
    --linearize \
    --subtract_background \
    --scales 16,8,4,2 \
    --n_itrs 500,500,500,100 \
    --pattern '*[!_max].dcm'
