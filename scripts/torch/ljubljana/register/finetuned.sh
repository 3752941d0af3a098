#!/bin/bash
# Multiscale registration of cerebral angiograms
# (reference scripts/ljubljana/register/finetuned.sh: scales 16,8,4,2).
set -e
SUBJECT=${SUBJECT:-subject01}

xvr-torch register model \
    data/ljubljana/$SUBJECT/xrays \
    -v data/ljubljana/$SUBJECT/volume.nii.gz \
    -c models/ljubljana/finetuned/$SUBJECT/0001.ckpt \
    -o results/ljubljana/register/finetuned/$SUBJECT \
    --linearize \
    --scales 16,8,4,2 \
    --n_itrs 500,500,500,100
