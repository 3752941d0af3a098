#!/usr/bin/env python3
"""The readings that set the limits of the foundation cell's ``correct``, at
the cell's own size, on several seeds, in one process.

    python3 portbench/control_foundation.py --seeds 1,2,3 [--controls bf16,pick,every_k_1]
                                            [--faults half_batch] [--tf32-off 1] [--out FILE]

For each seed: the run's own readings (the program through the checked
steps against the float32 reference), then each control, the reference put
in the program's place with one thing changed (``drivers/train_foundation.py``:
``bf16`` renders, ``pick`` from another seed, ``every_k_1``: no
accumulation), compared with the float32 reference as a run is; then each
fault, planted in the program and taken through the checked steps again on
the same subjects (``half_batch``: half of the batch left out of the loss,
its ``keep`` weights zeroed, as ``control.py`` plants it in the finetune
cell). With ``--tf32-off 1`` the program's checked steps also run once more with TF32
off in cuDNN and matrix products (the convolutions in float32, as the
reference's). Prints one JSON line per seed and reading; the benchmark's own
runs never run this.
"""

import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":  # run as a script: the checkout's root heads the path
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench import harness  # noqa: E402

VALUES = ("subject_gap", "render_gap", "cnn1_gap", "loss1_gap", "mncc1_gap", "grad_gap",
          "grad_gap_worst_leaf", "grad_gap_median", "step_gap", "step_gap_median")


def sound(c: dict, seed: int, device="cuda", tf32: bool = True):
    """The program's readings on ``seed`` -> (the work, its values)."""
    import torch

    work = harness.driver(c["traffic"]["kind"]).Work(c["config"], c["traffic"], seed, device)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    if not tf32:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        work.setup()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    _, info = work.check()
    return work, info


def fault(work, kind: str) -> dict:
    """The program's checked steps again on ``work``'s subjects with the
    fault ``kind`` planted, compared with the reference. -> the values."""
    from xvr_tpu_torch.train import trainer as tmod

    original = tmod.pose_regression_loss

    def half_batch(img, fg, pose, pimg, pfg, ppose, keep, sdd, **kw):
        keep = keep.clone()
        keep[keep.shape[0] // 2:] = 0.0
        return original(img, fg, pose, pimg, pfg, ppose, keep, sdd, **kw)

    if kind != "half_batch":
        raise ValueError(f"no fault {kind!r}")
    tmod.pose_regression_loss = half_batch
    try:
        work.steps = 0
        work.system()
    finally:
        tmod.pose_regression_loss = original
    return work.check()[1]


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="train.foundation")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="bf16,pick,every_k_1")
    ap.add_argument("--faults", default="half_batch")
    ap.add_argument("--tf32-off", type=int, default=0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    c = harness.cell(a.workload)
    harness.isolate_caches()
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    rows = []
    for seed in (int(s) for s in a.seeds.split(",")):
        runs = [("sound", True)] + ([("sound_tf32_off", False)] if a.tf32_off else [])
        for kind, tf32 in runs:
            t0 = time.perf_counter()
            work, info = sound(c, seed, tf32=tf32)
            rows.append(dict(seed=seed, kind=kind, seconds=time.perf_counter() - t0,
                             **{k: info[k] for k in VALUES if k in info}))
            print(json.dumps(rows[-1], default=float), flush=True)
        for kind in filter(None, a.controls.split(",")):
            t0 = time.perf_counter()
            info = work.control(kind)
            rows.append(dict(seed=seed, kind=kind, seconds=time.perf_counter() - t0,
                             **{k: info[k] for k in VALUES if k in info}))
            print(json.dumps(rows[-1], default=float), flush=True)
        for kind in filter(None, a.faults.split(",")):
            t0 = time.perf_counter()
            info = fault(work, kind)
            rows.append(dict(seed=seed, kind=kind, seconds=time.perf_counter() - t0,
                             **{k: info[k] for k in VALUES if k in info}))
            print(json.dumps(rows[-1], default=float), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(rows, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
