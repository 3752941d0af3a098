#!/bin/bash
# Sweep foundation-model checkpoints over every subject (init-only), then
# score to CSV (reference scripts/deepfluoro/evaluate/foundation.sh, SLURM
# array 0-1799 -> host loop).
set -e
CKPTDIR=${CKPTDIR:-models/wbct}

for SUBJDIR in data/deepfluoro/subject*/; do
    SUBJECT=$(basename "$SUBJDIR")
    for CKPTPATH in "$CKPTDIR"/*.ckpt; do
        CKPT_IDX=$(basename "$CKPTPATH" .ckpt)
        xvr-torch register model \
            "data/deepfluoro/$SUBJECT/xrays" \
            -v "data/deepfluoro/$SUBJECT/volume.nii.gz" \
            -m "data/deepfluoro/$SUBJECT/mask.nii.gz" \
            -c "$CKPTPATH" \
            -o "results/deepfluoro/evaluate/foundation/$SUBJECT/$CKPT_IDX" \
            --crop 100 \
            --linearize \
            --warp "data/deepfluoro/$SUBJECT/warp2template.txt" \
            --init_only \
            --verbose 0
    done
done

python scripts/torch/evaluate.py -f results/deepfluoro/evaluate/foundation \
    -s results/deepfluoro/evaluate/foundation.csv -d data
