"""The share of the traced window in which no operation ran on the card (%),
from the profiler's device intervals."""


def read(ctx):
    if not ctx.get("busy_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
