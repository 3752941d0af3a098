"""The device counters of the profiling module (K1/K4's slab tally) and the
benchmark's ``skip_share`` reader, on the CPU with a stand-in for the
device's buffer."""

from __future__ import annotations

import pytest

from portbench import harness
from xvr_tpu_torch.utils import profiling

METRICS = ["skip_share.register", "skip_share.sweep", "skip_share.train",
           "skip_share.foundation"]


@pytest.fixture
def tally(monkeypatch):
    """A stand-in for the kernels' slab tally, registered as the only device
    counters: a dict whose zeroings are counted."""
    buf = {"shearwarp.slabs_marched": 0, "shearwarp.slabs_skipped": 0, "zeroed": 0}

    def zero():
        buf.update({"shearwarp.slabs_marched": 0, "shearwarp.slabs_skipped": 0})
        buf["zeroed"] += 1

    def read():
        return {k: v for k, v in buf.items() if k != "zeroed"}

    monkeypatch.setattr(profiling, "_device_counters", [])
    monkeypatch.setattr(profiling, "_window", False)
    profiling.enable(False)
    profiling.reset()
    profiling.add_device_counters(zero, read)
    yield buf
    profiling.enable(False)
    profiling.reset()


def test_device_counters_start_where_tracing_turns_on(tally):
    """The device counts whether tracing is on or not; the counters start
    from zero at the first look after tracing turns on, and at ``reset``,
    and the snapshot reads them among the counters."""
    tally["shearwarp.slabs_marched"] = 7  # set-up, before the window
    assert profiling.span("register.render") is profiling.span("train.step")
    assert tally["zeroed"] == 0
    profiling.enable()
    with profiling.span("register.render"):
        assert tally["zeroed"] == 1 and tally["shearwarp.slabs_marched"] == 0
        tally["shearwarp.slabs_marched"] += 5
        tally["shearwarp.slabs_skipped"] += 3
    with profiling.span("register.render"):  # still on: no new start
        pass
    assert tally["zeroed"] == 1
    profiling.count("host_syncs")
    assert profiling.snapshot()["counters"] == {
        "host_syncs": 1, "shearwarp.slabs_marched": 5, "shearwarp.slabs_skipped": 3}
    profiling.enable(False)
    profiling.count("host_syncs")  # off: nothing, and the window has closed
    profiling.enable()
    profiling.count("host_syncs")
    assert tally["zeroed"] == 2
    profiling.reset()
    assert tally["zeroed"] == 3


@pytest.mark.parametrize("metric", METRICS)
def test_skip_share_reads_skipped_over_met(tally, metric):
    read = harness.reader(metric).read
    profiling.enable()
    profiling.count("register.iterations")  # the window opens: the counters start
    assert read({}) is None  # no K1/K4 block ran
    tally["shearwarp.slabs_marched"] += 30
    tally["shearwarp.slabs_skipped"] += 10
    assert read({}) == pytest.approx(25.0)


@pytest.mark.parametrize("metric", METRICS)
def test_skip_share_reads_nothing_without_the_counters(metric, monkeypatch):
    """A program without the tally (an older commit, or one that never
    launched K1/K4 on a card) reads nothing."""
    monkeypatch.setattr(profiling, "_device_counters", [])
    profiling.reset()
    read = harness.reader(metric).read
    assert read({}) is None
    profiling.enable()
    try:
        profiling.count("register.iterations", 4)
        assert read({}) is None
    finally:
        profiling.enable(False)
        profiling.reset()
