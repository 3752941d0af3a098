"""Profiling: named spans and counters of the host's work, and
``torch.profiler`` traces. Counterpart of ``xvr_tpu.utils.profiling``.

``with span(name):`` times a phase of the host's work and ``count(name, n)``
adds to a counter. Both record only while tracing is on: while a
``torch.profiler`` session runs, or after :func:`enable`. Off, each costs a
read and a compare of two flags and records nothing (``span`` returns one
shared no-op).
On, a span records its start and end (``perf_counter_ns``), its parent (the
span open around it on the same thread) and its request (the innermost span
opened with ``request=True`` on the thread: one ``run_batch``, one training
step; a span after it keeps its id until the next one opens), and adds its
time to its parent's child time: its self time is its time less its
children's. Under a profiler it also records an operator event
``xvr::<name>``, so the trace shows it on the device's clock: a host event
like ATen's (``_RecordFunctionFast``), where ``record_function``'s user
annotation would be mirrored onto the device's timeline as a busy
interval. A count adds to its counter's total and to the innermost open
span's; :func:`host_sync` counts the host's waits on the card.
:func:`snapshot` gives the totals by span name and counter and the span
records; :func:`reset` clears them.

Device counters are kept by the kernels themselves (K1/K4's slab tally,
``render/_cuda.py``), which count whether tracing is on or not, CUDA graph
replays included: they start again from zero when tracing turns on (found
at the first span, count or host sync after it does) and at :func:`reset`,
with no sync, and :func:`snapshot` reads them once, with the counters.

Set ``XVR_PROFILE_DIR=/path`` to capture a ``torch.profiler`` trace of
training steps 10-15 (after the first steps' set-up), written there as a
Chrome trace, ``trace_<pid>.json``, with the spans' snapshot of those steps
beside it, ``spans_<pid>.json``.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
from contextlib import nullcontext
from pathlib import Path
from time import perf_counter_ns

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

PREFIX = "xvr::"  # of a span's name in a profiler trace

_enabled = False
_local = threading.local()  # .stack: the open spans; .request: the current request's id
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_totals: dict[str, list] = {}  # name -> [count, ns, self ns, {counter: n}]
_counters: dict[str, int] = {}
_records: list[dict] = []
_device_counters: list = []  # (zero, read) of each set of device counters
_window = False  # whether tracing was on at the last look


def enable(on: bool = True) -> None:
    """Record spans and counts without a profiler (``on=False`` stops)."""
    global _enabled
    _enabled = bool(on)


def add_device_counters(zero, read) -> None:
    """Register counters the device keeps: ``zero()`` zeroes them without a
    sync, ``read()`` -> {name: total} reads them on the host."""
    _device_counters.append((zero, read))


def _tracing() -> bool:
    """Whether spans and counts record now; where tracing has turned on
    since the last look, the device counters start from zero."""
    global _window
    on = _enabled or _autograd_profiler._is_profiler_enabled
    if on != _window:
        _window = on
        if on:
            for zero, _ in _device_counters:
                zero()
    return on


_OFF = nullcontext()  # the span of tracing off


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "opens", "request", "id", "parent", "start", "child", "counts", "_rf")

    def __init__(self, name: str, opens: bool):
        self.name, self.opens = name, opens

    def __enter__(self):
        stack = _stack()
        self.start = perf_counter_ns()
        self.id = next(_span_ids)
        self.parent = stack[-1] if stack else None
        if self.opens:
            _local.request = next(_request_ids)
        self.request = getattr(_local, "request", None)
        self.child, self.counts, self._rf = 0, {}, None
        if _autograd_profiler._is_profiler_enabled:
            self._rf = _RecordFunctionFast(PREFIX + self.name)
            self._rf.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        end = perf_counter_ns()
        ns = end - self.start
        if self.parent is not None:
            self.parent.child += ns
        tot = _totals.get(self.name)
        if tot is None:
            tot = _totals[self.name] = [0, 0, 0, {}]
        tot[0] += 1
        tot[1] += ns
        tot[2] += ns - self.child
        for k, n in self.counts.items():
            tot[3][k] = tot[3].get(k, 0) + n
        _records.append(dict(
            id=self.id, name=self.name, parent=self.parent.id if self.parent else None,
            request=self.request, thread=threading.get_ident(), start_ns=self.start, end_ns=end,
            self_ns=ns - self.child, counts=self.counts,
        ))
        return False


def span(name: str, request: bool = False):
    """A context manager that records the block as the span ``name``;
    ``request=True`` opens a new request (a ``run_batch``, a training step)."""
    if not _tracing():
        return _OFF
    return _Span(name, request)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (and to the innermost open span's)."""
    if not _tracing():
        return
    _counters[name] = _counters.get(name, 0) + n
    stack = getattr(_local, "stack", None)
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def host_sync(on, n: int = 1) -> None:
    """Count ``n`` waits of the host on the device (the counter
    ``host_syncs``) when ``on``, a tensor or a device, is a CUDA device's: a
    device tensor read on the host, or a copy to it from pageable host
    memory, which waits for the device's queue to drain."""
    if not _tracing():
        return
    if (on.device if isinstance(on, torch.Tensor) else torch.device(on)).type == "cuda":
        count("host_syncs", n)


def snapshot() -> dict:
    """-> ``spans`` {name: count, seconds, self_seconds, counters (counted
    while it was the innermost span)}, ``counters`` {name: total}, the
    device counters' among them (read after the host waits for the device),
    and ``records`` (one per closed span, in the order they closed)."""
    spans = {k: dict(count=v[0], seconds=v[1] * 1e-9, self_seconds=v[2] * 1e-9, counters=dict(v[3]))
             for k, v in _totals.items()}
    counters = dict(_counters)
    for _, read in _device_counters:
        counters.update(read())
    return dict(spans=spans, counters=counters, records=list(_records))


def reset() -> None:
    _totals.clear()
    _counters.clear()
    _records.clear()
    for zero, _ in _device_counters:
        zero()


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_trace(logdir):
    """Start a torch.profiler session that writes to ``logdir`` when
    :func:`stop_trace` is called on it; the spans start afresh. -> the
    profiler."""
    Path(logdir).mkdir(parents=True, exist_ok=True)
    reset()
    prof = torch.profiler.profile(activities=_activities())
    prof.__enter__()
    prof.xvr_logdir = str(logdir)
    return prof


def stop_trace(prof) -> Path:
    """End ``prof`` and write its Chrome trace and the spans' snapshot
    beside it (``spans_<pid>.json``). -> the trace file."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    out = Path(prof.xvr_logdir) / f"trace_{os.getpid()}.json"
    prof.export_chrome_trace(str(out))
    (out.parent / f"spans_{os.getpid()}.json").write_text(json.dumps(snapshot()))
    return out


def maybe_trace_dir() -> str | None:
    return os.environ.get("XVR_PROFILE_DIR")
