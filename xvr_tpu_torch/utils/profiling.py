"""Profiling hooks: counterpart of ``xvr_tpu.utils.profiling``.

Set ``XVR_PROFILE_DIR=/path`` to capture a ``torch.profiler`` trace of
training steps 10-15 (after the first steps' set-up), written there as a
Chrome trace. :func:`trace` profiles any block, :func:`annotate` names a
host-side phase in the trace.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from pathlib import Path


def _activities():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_trace(logdir):
    """Start a torch.profiler session that writes to ``logdir`` when
    :func:`stop_trace` is called on it. -> the profiler."""
    import torch

    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    prof.__enter__()
    prof.xvr_logdir = str(logdir)
    return prof


def stop_trace(prof) -> Path:
    """End ``prof`` and write its Chrome trace. -> the trace file."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    out = Path(prof.xvr_logdir) / f"trace_{os.getpid()}.json"
    prof.export_chrome_trace(str(out))
    return out


@contextmanager
def trace(logdir):
    """Capture a torch.profiler trace of the block into ``logdir``."""
    prof = start_trace(logdir)
    try:
        yield prof
    finally:
        stop_trace(prof)


@contextmanager
def annotate(name: str):
    import torch

    with torch.profiler.record_function(name):
        yield


def maybe_trace_dir() -> str | None:
    return os.environ.get("XVR_PROFILE_DIR")
