#!/bin/bash
# Sweep finetuned checkpoints over the angiograms (init-only) and score
# (reference scripts/ljubljana/evaluate/finetuned.sh, array 0-309 -> loop).
set -e
CKPTDIR=${CKPTDIR:-models/ljubljana/finetuned}

for SUBJDIR in data/ljubljana/subject*/; do
    SUBJECT=$(basename "$SUBJDIR")
    for CKPTPATH in "$CKPTDIR/$SUBJECT"/*.ckpt; do
        CKPT_IDX=$(basename "$CKPTPATH" .ckpt)
        xvr-torch register model \
            "data/ljubljana/$SUBJECT/xrays" \
            -v "data/ljubljana/$SUBJECT/volume.nii.gz" \
            -c "$CKPTPATH" \
            -o "results/ljubljana/evaluate/finetuned/$SUBJECT/$CKPT_IDX" \
            --linearize \
            --subtract_background \
            --warp "data/ljubljana/$SUBJECT/warp2template.txt" \
            --init_only \
            --pattern '*[!_max].dcm' \
            --verbose 0
    done
done

python scripts/torch/evaluate.py -f results/ljubljana/evaluate/finetuned \
    -s results/ljubljana/evaluate/finetuned.csv -d data
