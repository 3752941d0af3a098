"""K1-K4's share of their roofline over the traced window (%): the summed
bound of every launch (:func:`portbench.counts.stage_work`) over the summed
device time of the shear-warp kernels in the profiler's trace."""

import re

from portbench.counts import window_work

SW = re.compile(r"\bsw_\w*kernel")


def read(ctx):
    device_s = sum(t for name, t in ctx.get("kernel_s", {}).items() if SW.search(name))
    if not device_s:
        return None
    return 100.0 * window_work(ctx)["bound_s"] / device_s
