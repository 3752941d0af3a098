"""The readers of the program's spans and counters: each returns a finite
number from a tiny traced run of its cell on the CPU (the port's plain
versions; the look for a card is skipped), and nothing from an empty
snapshot or from a window without iterations or steps."""

from __future__ import annotations

import copy
import json
import math
import os
from pathlib import Path

import pytest
import torch

from portbench import harness, spans
from xvr_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _reads_spans(metric: str) -> bool:
    return "portbench.spans" in Path(harness.reader(metric).__file__).read_text()


SPAN_METRICS = [m for m in BENCH["per_layer"] if _reads_spans(m["name"])]


def tiny(workload: str) -> dict:
    c = copy.deepcopy(harness.cell(workload))
    cfg, tr = c["config"], c["traffic"]
    if tr["kind"] == "register":
        cfg["ct"]["size"] = 32
        cfg["xray"].update(size=178, spacing=0.194 * 1436 / 178)
        cfg["registrar"].update(n_itrs="3,3,3", crop=50, scales="12,6,3")
        tr.update(pool=2, batch=min(tr["batch"], 2), max_requests=2, warmup_itrs=1,
                  init=[2.0, 12.0])
    else:
        cfg["ct"]["size"] = 32
        cfg["trainer"].update(batch_size=4, height=32, delx=8.0)
        tr.update(checked_steps=1, traced_requests=2)
    return c


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The result line and the snapshot of a tiny traced run of each cell."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XVR_FORCE_SHEARWARP", "1")
        mp.setenv("TMPDIR", str(tmp_path_factory.mktemp("spans")))
        threads = torch.get_num_threads()
        torch.set_num_threads(max(1, min(2, os.cpu_count() or 1)))
        try:
            for w in sorted({w for m in SPAN_METRICS for w in m["workloads"]}):
                profiling.reset()
                res = harness.run_cell(tiny(w), 3000000021, 0.0, True, 0.0, device="cpu")
                out[w] = (res, profiling.snapshot())
        finally:
            torch.set_num_threads(threads)
            profiling.reset()
    return out


def test_fifteen_readers_of_spans_report_in_their_cells():
    assert len(SPAN_METRICS) == 22
    assert len({harness.reader(m["name"]).__file__ for m in SPAN_METRICS}) == 15
    assert all(m["source"] in ("program_span", "program_counter") and m["workloads"]
               for m in SPAN_METRICS)


@pytest.mark.parametrize("metric", [m["name"] for m in SPAN_METRICS])
def test_reader_gives_a_number_from_a_traced_run(traced, metric):
    m = next(x for x in SPAN_METRICS if x["name"] == metric)
    for w in m["workloads"]:
        res, snap = traced[w]
        assert snap["spans"], w
        value = res["metrics"][metric]["value"]
        assert math.isfinite(value) and value >= 0, (w, value)


def test_stage_spans_add_up_to_the_stage_seconds(traced):
    """The five loop spans' self times per iteration, against the stage
    seconds of ``stage_log`` per iteration (``ms_per_itr``)."""
    for w in ("register.intraop", "register.sweep8"):
        res, snap = traced[w]
        suffix = "register" if w == "register.intraop" else "sweep"
        parts = sum(res["metrics"][f"{k}.{suffix}"]["value"]
                    for k in ("render_ms_per_itr", "similarity_ms_per_itr", "backward_ms_per_itr",
                              "update_ms_per_itr", "sync_wait_ms_per_itr"))
        assert parts == pytest.approx(res["metrics"][f"ms_per_itr.{suffix}"]["value"], rel=0.1)


@pytest.mark.parametrize("metric", [m["name"] for m in SPAN_METRICS])
def test_reader_gives_nothing_from_an_empty_snapshot(metric):
    profiling.reset()
    stages = [dict(n_done=5, seconds=0.1, height=8)]
    ctx = dict(window_s=1.0, steps=3, requests=[dict(gt=[None], stages=stages)])
    assert spans.snapshot() is None
    assert harness.reader(metric).read(ctx) is None
