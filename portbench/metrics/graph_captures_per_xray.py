"""CUDA graph captures per X-ray over the traced window: the program's
counter ``register.graph_captures`` (none counted reads 0) over the X-rays
registered. Nothing where the program replays no graphs (no
``register.graph_replays``)."""

from portbench.spans import snapshot, window_xrays


def read(ctx):
    snap = snapshot()
    n = window_xrays(ctx)
    if snap is None or not n or "register.graph_replays" not in snap["counters"]:
        return None
    return snap["counters"].get("register.graph_captures", 0) / n
