"""Reduction of a ``torch.profiler`` record of the traced window.

From the profiler's kernel intervals: the number of ATen operator calls
on the host, the seconds in which some operation
ran on the device (``busy_s``, overlapping intervals merged), device seconds
by kernel name, the ten operations that took the most device time, and the
device's idle time grouped by what the host was doing meanwhile (the
innermost host operation running at the middle of each idle gap, or none:
the host between operators).

Frozen: later changes to the benchmark may add beside this file, not edit it.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

BACK = 256  # host ops looked back through for one covering a gap
NAME = 160  # characters kept of a kernel's name
TOP = 10


def _ns(ev, what: str) -> float:
    if hasattr(ev, f"{what}_ns"):
        return float(getattr(ev, f"{what}_ns")())
    return float(getattr(ev, f"{what}_us")()) * 1e3


def events(prof):
    """-> (device [(name, start_ns, end_ns)], host [(name, start_ns, end_ns)])."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        kind = ev.device_type()
        if kind == DeviceType.CUDA:
            dev.append((ev.name(), start, end))
        elif kind == DeviceType.CPU:
            host.append((ev.name(), start, end))
    return dev, host


def reduce(prof) -> dict:
    """The traced window's device record: ``busy_s``, ``kernel_s`` {name:
    seconds}, ``device_ops`` and ``idle_gaps`` (each at most ten [name,
    seconds] pairs, largest first)."""
    dev, host = events(prof)
    aten = sum(1 for name, _, _ in host if name.startswith("aten::"))
    if not dev:
        return dict(busy_s=0.0, kernel_s={}, device_ops=[], idle_gaps=[], aten_calls=aten)
    kernel_s = defaultdict(float)
    for name, s, e in dev:
        kernel_s[name] += (e - s) * 1e-9
    iv = np.array(sorted((s, e) for _, s, e in dev), dtype=np.float64)
    # merge overlapping intervals; the gaps between merged runs are idle
    ends = np.maximum.accumulate(iv[:, 1])
    new_run = np.concatenate([[True], iv[1:, 0] > ends[:-1]])
    starts = iv[new_run, 0]
    run_ends = np.concatenate([ends[np.flatnonzero(new_run)[1:] - 1], ends[-1:]])
    busy_s = float((run_ends - starts).sum()) * 1e-9
    gaps_lo, gaps_hi = run_ends[:-1], starts[1:]
    idle = defaultdict(float)
    if gaps_lo.size:
        mid = 0.5 * (gaps_lo + gaps_hi)
        label = np.full(mid.shape, -1)
        if host:
            host.sort(key=lambda h: h[1])
            h_start = np.array([h[1] for h in host])
            h_end = np.array([h[2] for h in host])
            i = np.searchsorted(h_start, mid) - 1
            # the latest-starting host op that covers the gap's middle
            for back in range(BACK):
                j = i - back
                ok = (label < 0) & (j >= 0) & (h_end[np.maximum(j, 0)] >= mid)
                label[ok] = j[ok]
        for g, lab in zip((gaps_hi - gaps_lo) * 1e-9, label):
            idle[host[lab][0] if lab >= 0 else "(host between operators)"] += g
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(busy_s=busy_s, kernel_s=dict(kernel_s), aten_calls=aten,
                device_ops=[[k[:NAME], v] for k, v in top],
                idle_gaps=[[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]])
