"""K1-K4's share of their roofline over the traced training steps (%): a
step's summed launch bounds (:func:`portbench.counts.train_step_work`) times
the steps, over the shear-warp kernels' device time in the trace."""

import re

from portbench.counts import train_step_work

SW = re.compile(r"\bsw_\w*kernel")


def read(ctx):
    device_s = sum(t for name, t in ctx.get("kernel_s", {}).items() if SW.search(name))
    if not device_s or not ctx.get("steps"):
        return None
    return 100.0 * ctx["steps"] * train_step_work(ctx)["bound_s"] / device_s
