#!/bin/bash
# Register femur X-rays with a de-novo model, then refine each result from
# its saved final pose at finer scales (reference
# scripts/femur/register/de_novo.sh: model pass 16,8,4 then restart 4,2).
set -e
SUBJECT=${SUBJECT:-subject01}
CKPT=${CKPT:-models/femur/de_novo/$SUBJECT}

xvr-torch register model \
    data/femur/$SUBJECT/xrays \
    -v data/femur/$SUBJECT/volume.nii.gz \
    -m data/femur/$SUBJECT/mask_all.nii.gz \
    -c $CKPT \
    -o results/femur/register/de_novo/$SUBJECT \
    --labels 1,2,3,4 \
    --crop 20 \
    --scales 16,8,4 \
    --n_itrs 500,250,100

for FILE in data/femur/$SUBJECT/xrays/*.dcm; do
    XRAY=$(basename "$FILE" .dcm)
    xvr-torch register restart \
        "$FILE" \
        -v data/femur/$SUBJECT/volume.nii.gz \
        -m data/femur/$SUBJECT/mask_all.nii.gz \
        --ckpt results/femur/register/de_novo/$SUBJECT/$XRAY/parameters.npz \
        -o results/femur/register/de_novo_restart/$SUBJECT \
        --orientation AP \
        --crop 20 \
        --scales 4,2 \
        --n_itrs 250,100 \
        --lr_rot 1e-3 \
        --lr_xyz 1e-1
done
