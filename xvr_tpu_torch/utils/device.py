"""Constants made on the host once and then kept on each device."""

from __future__ import annotations

import functools

import torch

from .profiling import host_sync


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype)`` on ``device``: copied from the
    host at the first call for these arguments (on a CUDA device that copy
    waits for the device, and is counted) and the same tensor after, so a
    caller in a loop copies nothing, and a CUDA graph can read it. Never
    write to it. Entries are never dropped (a captured graph may still read
    one), so ``values`` should come from a small set."""
    host_sync(device)
    return torch.tensor(values, dtype=dtype).to(device)
