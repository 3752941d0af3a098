#!/bin/bash
# Sweep every finetuned checkpoint over every subject's X-rays (init-only,
# i.e. CNN prediction quality without refinement), then score to CSV.
# Reference scripts/deepfluoro/evaluate/finetuned.sh runs this as a SLURM
# array (one checkpoint x subject per GPU); here a single host loops —
# the init-only path is one CNN forward per X-ray.
set -e
CKPTDIR=${CKPTDIR:-models/deepfluoro/finetuned}

for SUBJDIR in data/deepfluoro/subject*/; do
    SUBJECT=$(basename "$SUBJDIR")
    for CKPTPATH in "$CKPTDIR/$SUBJECT"/*.ckpt; do
        CKPT_IDX=$(basename "$CKPTPATH" .ckpt)
        xvr-torch register model \
            "data/deepfluoro/$SUBJECT/xrays" \
            -v "data/deepfluoro/$SUBJECT/volume.nii.gz" \
            -m "data/deepfluoro/$SUBJECT/mask.nii.gz" \
            -c "$CKPTPATH" \
            -o "results/deepfluoro/evaluate/finetuned/$SUBJECT/$CKPT_IDX" \
            --crop 100 \
            --linearize \
            --warp "data/deepfluoro/$SUBJECT/warp2template.txt" \
            --init_only \
            --verbose 0
    done
done

python scripts/torch/evaluate.py -f results/deepfluoro/evaluate/finetuned \
    -s results/deepfluoro/evaluate/finetuned.csv -d data
