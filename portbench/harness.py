"""The benchmark harness: one run of one cell.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

The cell's entry in ``BENCHMARK.json`` names its configuration (its file,
``portbench/configs/<config>.json``) and its traffic mix
(``portbench/traffic/<traffic>.json``); the mix's ``kind`` names the driver
that serves it (``portbench/drivers/<kind>.py``), and each per-layer metric
of the cell is read by ``portbench/metrics/<metric>.py``, or, where the
metric's cells share one reader, by ``portbench/metrics/<name before the
first dot>.py``. A cell, a mix or a metric is added as new files; nothing
here names one.

A driver makes the inputs from the seed, builds the system under test and
warms it up (set-up), serves the mix for ``--seconds`` (the window), and then
checks what the window produced against the plain reference. The harness
times set-up, traces the window with ``torch.profiler`` under ``--trace 1``,
reads the per-layer metrics, and prints the result as the last line of
standard output, the numbers compared with their limits last on standard
error.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "xvr_tpu")  # top-level module names, compared whole


def load_file(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(workload: str, root: Path = ROOT) -> dict:
    """The cell ``workload`` of ``BENCHMARK.json`` with its configuration,
    traffic mix and the metrics it reports, each read from its own file."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((PKG / "traffic" / f"{entry['traffic']}.json").read_text())

    def reported(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return dict(name=workload, chips=int(entry["chips"]), config=config, traffic=traffic,
                end_to_end=reported(bench["end_to_end"]), per_layer=reported(bench["per_layer"]))


def driver(kind: str):
    return load_file(f"portbench_driver_{kind}", PKG / "drivers" / f"{kind}.py")


def reader(metric: str):
    """The reader of ``metric``: ``metrics/<metric>.py``, else the reader its
    cells share, ``metrics/<the name before the first dot>.py``."""
    path = PKG / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = PKG / "metrics" / f"{metric.split('.')[0]}.py"
    return load_file(f"portbench_metric_{metric.replace('.', '_')}", path)


def isolate_caches(root: Path = ROOT) -> None:
    """Keep the program's kernel build, and any CUDA JIT cache, at fixed
    paths inside the checkout; keep libraries from loading JAX."""
    build = root / "build" / "portbench"
    os.environ["XVR_TORCH_BUILD_DIR"] = str(build / "kernels")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return res.stdout.strip().splitlines()[0].split(",")[-1].strip()
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_cell(c: dict, seed: int, seconds: float, trace: bool, t_start: float, device="cuda",
             out: str | None = None) -> dict:
    """One run of the cell ``c`` (:func:`cell`). -> the result object."""
    import torch

    drv = driver(c["traffic"]["kind"])
    work = drv.Work(c["config"], c["traffic"], seed, device)
    work.setup()
    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"portbench: {c['name']} seed {seed}: set-up {setup_s:.3f} s")

    prof = None
    if trace:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    window = work.serve(t0, seconds, trace)
    if device != "cpu":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    traced = None
    if prof is not None:
        prof.__exit__(None, None, None)
        from . import trace as tr

        traced = tr.reduce(prof)
        del prof
    peak = int(torch.cuda.max_memory_allocated()) if device != "cpu" else 0

    checks, info = work.check()
    correct = all(v["value"] <= v["limit"] for v in checks.values()) and window["failed"] == 0
    for k, v in info.items():
        if not isinstance(v, list):
            log(f"portbench: {k} {v}")

    ctx = dict(window_s=window_s, **window, **work.context())
    if traced is not None:
        ctx.update(busy_s=traced["busy_s"], kernel_s=traced["kernel_s"],
                   aten_calls=traced["aten_calls"])
    metrics = {}
    if not trace:
        for m in c["end_to_end"]:
            value = window["e2e"][m["name"]] if m["name"] != "setup_s" else setup_s
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in c["per_layer"]:
            value = reader(m["name"]).read(ctx)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        log(f"portbench: forbidden modules loaded: {found}")
        raise SystemExit(3)
    power = power_limit() if device != "cpu" else "none"
    dev = dict(platform="gpu" if device != "cpu" else "cpu",
               kind=torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
               count=c["chips"], memory_peak_bytes=peak, power_limit=power)
    result = dict(correct=bool(correct), attempted=window["attempted"], failed=window["failed"],
                  metrics=metrics, device=dev)
    if traced is not None:
        dev.update(busy_s=traced["busy_s"], window_s=window_s)
        result["breakdown"] = dict(device_ops=traced["device_ops"], idle_gaps=traced["idle_gaps"])
    result["checks"] = checks
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(dict(result, workload=c["name"], seed=seed, seconds=seconds,
                                             trace=trace, setup_s=setup_s, info=info), default=float))
    for k, v in metrics.items():
        log(f"portbench: {k} = {v['value']} {v['unit']} (power limit {power})")
    for k, v in checks.items():
        log(f"check {k}: {v['value']} (limit {v['limit']})")
    return result


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None, help="also write the run's record (JSON) here")
    a = ap.parse_args(argv)
    c = cell(a.workload)
    isolate_caches()

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < c["chips"]:
        log(f"portbench: {c['name']} needs {c['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(2)
    result = run_cell(c, a.seed, a.seconds, bool(a.trace), t_start, out=a.out)
    print(json.dumps(result, default=float), flush=True)
    return 0
