#!/usr/bin/env python3
"""The readings that set the limits of the biplane cell's ``correct``, at the
cell's own size, on several seeds, in one process.

    python3 portbench/control_biplane.py --seeds 1,2,3 [--out FILE]

As ``control.py`` reads the register cells: the control is the reference
put in the program's place with its render computed in bfloat16 (the hat
factors, their products and the slope image rounded, as a march moved onto
tensor cores would round them): its similarity at the view and at the
initial pose of each X-ray of the pool, against the float32 reference's
(``sim_gap``, which the cell reports and does not check), and its renders
at the stage's batch about each pose against the float32 reference's
(``render_gap``: the least over the pool, since one X-ray so rendered fails
the run). The fault "a step that returns its state unchanged" leaves an
X-ray at its initial pose, and one X-ray left so reads at least the smallest
of the pool's initial distances: its reading of ``mpd_max_mm`` is that
smallest.

Prints one JSON line per seed; the benchmark's own runs never run this.
"""

import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":  # run as a script: the checkout's root heads the path
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench import harness  # noqa: E402

CELL = "register.biplane"


def readings(c: dict, seed: int, device="cuda") -> dict:
    from portbench import reference as ref

    drv = harness.driver(c["traffic"]["kind"])
    work = drv.Work(c["config"], c["traffic"], seed, device)
    work.subject()
    items = [(i, drv.scene.poses(rot, xyz, "cpu").numpy().reshape(4, 4))
             for i, (rot, xyz) in enumerate(work.inits)]
    views = [(i, work.gt[i].numpy()) for i, _ in items]
    with ref.no_tf32():
        f32 = work.reference_similarity(views + items)
        bf16 = work.reference_similarity(views + items, "bfloat16")
        render16 = [work.render_gap(pose, precision="bfloat16") for _, pose in views + items]
    gaps = [abs(a - b) for a, b in zip(f32, bf16)]
    mpd0 = [ref.projection_distance(init, work.gt[i].numpy(), work.fids, work.det.sdd)
            for i, init in items]
    return dict(control_sim_gap=max(gaps), control_sim_gaps=gaps,
                control_render_gap=min(render16), control_render_gaps=render16,
                unchanged_state_mpd_max_mm=max(mpd0), one_unchanged_mpd_max_mm=min(mpd0),
                init_mpd_mm=mpd0, sim_at_views=f32[: len(views)])


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    c = harness.cell(CELL)
    harness.isolate_caches()
    if not torch.cuda.is_available():
        print("control_biplane: no CUDA device", file=sys.stderr)
        return 2
    rows = []
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings(c, seed)
        row = dict(workload=CELL, seed=seed, reading="control", seconds=time.perf_counter() - t0, **r)
        rows.append(row)
        print(json.dumps(row, default=float), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text("\n".join(json.dumps(r, default=float) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
