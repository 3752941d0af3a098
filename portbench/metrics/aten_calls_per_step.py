"""ATen operator calls on the host per training step in the traced window,
from the profiler's host events; the reader of every training cell without
one of its own."""


def read(ctx):
    if not ctx.get("steps") or not ctx.get("aten_calls"):
        return None
    return ctx["aten_calls"] / ctx["steps"]
