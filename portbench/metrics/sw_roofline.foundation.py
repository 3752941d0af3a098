"""K1-K4's share of their roofline over the traced foundation steps (%): the
summed launch bounds of the window's steps, each counted on its subject's
own, unpadded shape (:func:`portbench.counts_foundation.window_work`), over
the shear-warp kernels' device time in the trace."""

import re

from portbench.counts_foundation import window_work

SW = re.compile(r"\bsw_\w*kernel")


def read(ctx):
    device_s = sum(t for name, t in ctx.get("kernel_s", {}).items() if SW.search(name))
    if not device_s or not ctx.get("steps"):
        return None
    work = window_work(ctx)
    return None if work is None else 100.0 * work["bound_s"] / device_s
