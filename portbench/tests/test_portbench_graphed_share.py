"""``graphed_share``: the share of the registrar's iterations that ran as one
replay of a CUDA graph, read from the program's counters."""

from __future__ import annotations

import pytest

from portbench import harness, spans
from xvr_tpu_torch.utils import profiling

METRICS = ["graphed_share.register", "graphed_share.sweep"]


@pytest.mark.parametrize("metric", METRICS)
def test_graphed_share_reads_replays_over_iterations(metric):
    """Nothing without the replay counter (a program without graphs), else
    100 × ``register.graph_replays`` / ``register.iterations``."""
    ctx = dict(window_s=1.0, requests=[dict(gt=[None], stages=[dict(n_done=8, seconds=0.1)])])
    read = harness.reader(metric).read
    profiling.reset()
    profiling.enable()
    try:
        profiling.count("register.iterations", 8)
        assert read(ctx) is None
        profiling.count("register.graph_replays", 6)
        assert read(ctx) == pytest.approx(75.0)
        profiling.count("register.graph_replays", 2)
        assert read(ctx) == pytest.approx(100.0)
    finally:
        profiling.enable(False)
        profiling.reset()


@pytest.mark.parametrize("metric", METRICS)
def test_graphed_share_gives_nothing_without_iterations(metric):
    """An empty snapshot, or replays counted in a window without iterations
    (a training cell), read nothing."""
    profiling.reset()
    ctx = dict(window_s=1.0, steps=3, requests=[])
    assert spans.snapshot() is None
    read = harness.reader(metric).read
    assert read(ctx) is None
    profiling.enable()
    try:
        profiling.count("register.graph_replays", 4)
        assert read(ctx) is None
    finally:
        profiling.enable(False)
        profiling.reset()
