#!/usr/bin/env python3
"""The readings that set the limits of ``correct``: the control and the
faults, at a cell's own size, on several seeds, in one process.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--out FILE]

``register`` cells: the control is the reference put in the program's place
with its render computed in bfloat16 (the hat factors, their products and the
slope image rounded, as a march moved onto tensor cores would round them):
its similarity at the view and at the initial pose of each X-ray of the
pool, against the float32 reference's (``sim_gap``). The
fault "a step that returns its state unchanged" leaves every X-ray at its
initial pose, and one X-ray left so reads at least the smallest of the
pool's initial distances: its reading of ``mpd_max_mm`` is that smallest.

``train`` cells: two controls, each compared as a run compares with the
float32 reference: the reference put in the program's place with its
renders in bfloat16, as above, through the cell's checked steps
(``reference_bf16``: read by ``render_gap``), and the program's own
bfloat16 path (``program_bf16``, ``compute_dtype="bfloat16"``: the
convolutions under bf16 autocast where the configuration states TF32; read
by ``cnn1_gap``). Faults,
each planted in the program: half of the batch left out of the loss (its
``keep`` weights zeroed, the mean taken over the rest); the loss altered
where it is produced (times 1.1). The fault "a step that returns its state
unchanged" reads 1 by ``step_gap``'s measure and needs no run.

Prints one JSON line per seed and reading; the benchmark's own runs never run
this.
"""

import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":  # run as a script: the checkout's root heads the path
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench import harness  # noqa: E402


def register_readings(c: dict, seed: int, device="cuda") -> dict:
    from portbench import reference as ref

    drv = harness.driver("register")
    work = drv.Work(c["config"], c["traffic"], seed, device)
    work.subject()
    items = [(i, drv.scene.poses(rot, xyz, "cpu").numpy().reshape(4, 4))
             for i, (rot, xyz) in enumerate(work.inits)]
    views = [(i, work.gt[i].numpy()) for i, _ in items]
    with ref.no_tf32():
        f32 = work.reference_similarity(views + items)
        bf16 = work.reference_similarity(views + items, "bfloat16")
    gaps = [abs(a - b) for a, b in zip(f32, bf16)]
    mpd0 = [ref.projection_distance(init, work.gt[i].numpy(), work.fids, work.det.sdd)
            for i, init in items]
    return dict(control_sim_gap=max(gaps), control_sim_gaps=gaps,
                unchanged_state_mpd_max_mm=max(mpd0), one_unchanged_mpd_max_mm=min(mpd0),
                init_mpd_mm=mpd0)


def train_readings(c: dict, seed: int, kind: str, device="cuda") -> dict:
    from xvr_tpu_torch.train import trainer as tmod

    drv = harness.driver("train")
    work = drv.Work(c["config"], c["traffic"], seed, device)
    if kind == "reference_bf16":
        work.subject()
        _, info = work.compare(work.reference_run("bfloat16"), work.reference_run("float32"))
        return info
    original = tmod.pose_regression_loss

    def half_batch(img, fg, pose, pimg, pfg, ppose, keep, sdd, **kw):
        keep = keep.clone()
        keep[keep.shape[0] // 2:] = 0.0
        return original(img, fg, pose, pimg, pfg, ppose, keep, sdd, **kw)

    def altered(*a, **kw):
        loss, metrics = original(*a, **kw)
        return loss * 1.1, metrics

    if kind == "program_bf16":
        work.compute_dtype = "bfloat16"
    try:
        tmod.pose_regression_loss = {"half_batch": half_batch, "altered_loss": altered}.get(
            kind, original)
        work.setup()
    finally:
        tmod.pose_regression_loss = original
    _, info = work.check()
    return {k: v for k, v in info.items() if k != "setup_phases"}


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="reference_bf16,program_bf16,half_batch,altered_loss",
                    help="train cells: the control and the faults to read")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    c = harness.cell(a.workload)
    harness.isolate_caches()
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    rows = []
    for seed in (int(s) for s in a.seeds.split(",")):
        kinds = ["control"] if c["traffic"]["kind"] == "register" else a.faults.split(",")
        for kind in kinds:
            t0 = time.perf_counter()
            if c["traffic"]["kind"] == "register":
                r = register_readings(c, seed)
            else:
                r = train_readings(c, seed, kind)
            row = dict(workload=a.workload, seed=seed, reading=kind,
                       seconds=time.perf_counter() - t0, **r)
            rows.append(row)
            print(json.dumps(row, default=float), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text("\n".join(json.dumps(r, default=float) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
