#!/usr/bin/env python3
"""Where a benchmark cell's host time goes, by the program's spans, on the card.

    python3 scripts/chip_spans.py --workload register.intraop --seed 5 \\
        --mode traced|spans [--seconds 51] [--out spans.json]

Runs one cell of ``BENCHMARK.json`` as ``portbench/run.py`` does (set-up and
warm-up untraced, then the window), with the window under ``torch.profiler``
(``traced``, as ``--trace 1``) or with the spans alone
(``spans``: ``profiling.enable()``, no profiler, so the host runs at its own
speed). Prints each span's count and self milliseconds per iteration (or
per step), the counters, the window's ms per iteration or step, the
per-layer metrics read from the spans and, traced, the share of kernel
launches inside a leaf span, the device kernels whose name matches
``--place`` by the leaf span and the ATen operator that launched them, and
the device's idle gaps by the frozen reducer's labels and by the leaf span
open at each gap. The result check is left out.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from bisect import bisect_right
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")  # and their Ex forms


def kineto(prof):
    """-> (device [(name, start, end, correlation)], host [(name, start,
    end, correlation)]), in ns."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        row = (ev.name(), s, s + ev.duration_ns(), ev.correlation_id())
        (dev if ev.device_type() == DeviceType.CUDA else host).append(row)
    return dev, host


def innermost(intervals, t):
    """The shortest of ``intervals`` [(name, start, end)] that covers t."""
    best = None
    for name, s, e in intervals:
        if s <= t <= e and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    return best[0] if best else "(none)"


def placed(dev, host, leaves, pattern):
    """Device seconds of the kernels matching ``pattern`` by (leaf span,
    ATen operator) of their launch."""
    launch = {c: s for n, s, _, c in host if c and n.startswith("cu")}  # runtime calls
    spans = [(n, s, e) for n, s, e, _ in host if n in leaves]
    aten = sorted((s, e, n) for n, s, e, _ in host if n.startswith("aten::"))
    starts = [s for s, _, _ in aten]
    out = defaultdict(float)
    for name, s, e, c in dev:
        if not re.search(pattern, name) or c not in launch:
            continue
        t = launch[c]
        j = bisect_right(starts, t)
        ops = [(n, a, b) for a, b, n in aten[max(j - 64, 0):j] if b >= t]
        out[(innermost(spans, t), innermost(ops, t), name[:60])] += (e - s) * 1e-9
    return sorted(([*k, v] for k, v in out.items()), key=lambda r: -r[-1])


def idle_by_span(dev, host, leaves):
    """The device's idle seconds by the leaf span open at each gap's middle
    (by time alone, however many operators the span holds)."""
    iv = sorted((s, e) for _, s, e, _ in dev)
    spans = sorted((s, e, n) for n, s, e, _ in host if n in leaves)
    starts = [s for s, _, _ in spans]
    out, end = defaultdict(float), iv[0][1] if iv else 0
    for s, e in iv[1:]:
        if s > end:
            mid = 0.5 * (s + end)
            j = bisect_right(starts, mid) - 1
            name = spans[j][2] if j >= 0 and spans[j][1] >= mid else "(no leaf span)"
            out[name] += (s - end) * 1e-9
        end = max(end, e)
    return sorted(([k, v] for k, v in out.items()), key=lambda r: -r[1])


def coverage(host, leaves):
    spans = sorted((s, e) for n, s, e, _ in host if n in leaves)
    starts = [s for s, _ in spans]
    launches = [(s, e) for n, s, e, _ in host if n.startswith(LAUNCHES)]
    inside = 0
    for s, e in launches:
        j = bisect_right(starts, s) - 1
        inside += j >= 0 and spans[j][0] <= s and e <= spans[j][1]
    return inside, len(launches)


def run(c: dict, seed: int, mode: str, seconds: float, place: str = "gemm", device="cuda"):
    """One window of the cell ``c`` (``portbench.harness.cell``) -> the record."""
    import torch

    from portbench import harness, spans, trace
    from xvr_tpu_torch.utils import profiling

    cuda = device != "cpu"
    work = harness.driver(c["traffic"]["kind"]).Work(c["config"], c["traffic"], seed, device)
    work.setup()
    if cuda:
        torch.cuda.synchronize()
    profiling.reset()
    prof = None
    if mode == "traced":
        acts = [torch.profiler.ProfilerActivity.CPU]
        prof = torch.profiler.profile(activities=acts + [torch.profiler.ProfilerActivity.CUDA]
                                      if cuda else acts)
        prof.__enter__()
    else:
        profiling.enable()
    t0 = time.perf_counter()
    window = work.serve(t0, seconds, True)
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    profiling.enable(False)
    ctx = dict(window_s=window_s, **window, **work.context())
    rec = dict(workload=c["name"], seed=seed, mode=mode, window_s=window_s,
               card=torch.cuda.get_device_name(0) if cuda else "cpu",
               power_limit=harness.power_limit() if cuda else "none")
    if prof is not None:
        prof.__exit__(None, None, None)
        red = trace.reduce(prof)
        ctx.update(busy_s=red["busy_s"], kernel_s=red["kernel_s"], aten_calls=red["aten_calls"])
        dev, host = kineto(prof)
        snap = profiling.snapshot()
        parents = {r["parent"] for r in snap["records"]}
        leaves = {profiling.PREFIX + r["name"] for r in snap["records"] if r["id"] not in parents}
        inside, n = coverage(host, leaves)
        rec.update(busy_s=red["busy_s"], idle_gaps=red["idle_gaps"], device_ops=red["device_ops"],
                   aten_calls=red["aten_calls"], launches=n, launches_in_leaf_spans=inside,
                   placed=placed(dev, host, leaves, place)[:12],
                   idle_by_span=idle_by_span(dev, host, leaves))
    snap = profiling.snapshot()
    iters = snap["counters"].get("register.iterations", 0)
    per = iters or ctx.get("steps") or 1
    rec.update(
        per="iteration" if iters else "step", n=per,
        stage_log_iterations=spans.window_iterations(ctx), steps=ctx.get("steps"),
        ms_per=1e3 * window_s / per,
        spans={k: dict(count=v["count"], ms_per=1e3 * v["seconds"] / per,
                       self_ms_per=1e3 * v["self_seconds"] / per, counters=v["counters"])
               for k, v in snap["spans"].items()},
        counters=snap["counters"],
        metrics={m["name"]: harness.reader(m["name"]).read(ctx) for m in c["per_layer"]
                 if m["source"] in ("program_span", "program_counter")},
    )
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--mode", choices=("traced", "spans"), required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--place", default=r"gemm", help="kernels to place by span (regex)")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()

    import torch

    from portbench import harness

    c = harness.cell(a.workload)
    harness.isolate_caches()
    torch.set_num_threads(2)
    text = json.dumps(run(c, a.seed, a.mode, a.seconds, a.place), default=float)
    print(text, flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(text)


if __name__ == "__main__":
    main()
