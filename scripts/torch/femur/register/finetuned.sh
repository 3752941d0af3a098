#!/bin/bash
set -e
SUBJECT=${SUBJECT:-subject01}
xvr-torch register model \
    data/femur/$SUBJECT/xrays \
    -v data/femur/$SUBJECT/volume.nii.gz \
    -c models/femur/finetuned/$SUBJECT/0001.ckpt \
    -o results/femur/register/finetuned/$SUBJECT \
    --linearize --scales 8 --n_itrs 500
