"""The program's spans and counters over a traced window, for the per-layer
metrics that read them.

The registrar and the trainer open spans (``xvr_tpu_torch.utils.profiling``)
while a profiler runs: under ``--trace 1`` that is the window alone, so
``snapshot()`` holds the window's spans. A program without them (an older
commit) has nothing to read, and every function here returns ``None``.
"""

from __future__ import annotations


def snapshot() -> dict | None:
    """The program's spans and counters, or None when it recorded none."""
    from xvr_tpu_torch.utils import profiling

    snap = getattr(profiling, "snapshot", lambda: None)()
    if not snap or not (snap["spans"] or snap["counters"]):
        return None
    return snap


def window_iterations(ctx) -> int:
    """Registrar iterations of the window by ``stage_log`` (0 outside a
    register cell)."""
    return sum(st["n_done"] for req in ctx.get("requests", []) for st in req["stages"])


def window_xrays(ctx) -> int:
    return sum(len(req["gt"]) for req in ctx.get("requests", []))


def seconds(snap: dict, name: str, self_time: bool = True) -> float:
    """Seconds of the spans ``name``: their self time, or their whole time."""
    s = snap["spans"].get(name)
    if s is None:
        return 0.0
    return s["self_seconds"] if self_time else s["seconds"]


def per_itr(ctx, value) -> float | None:
    """``value(snapshot)`` per registrar iteration (the program's own count,
    ``register.iterations``), or None without iterations or spans."""
    snap = snapshot()
    if not window_iterations(ctx) or snap is None:
        return None
    n = snap["counters"].get("register.iterations", 0)
    return value(snap) / n if n else None


def per_step(ctx, value) -> float | None:
    """``value(snapshot)`` per training step of the window, or None."""
    snap = snapshot()
    if not ctx.get("steps") or snap is None:
        return None
    return value(snap) / ctx["steps"]


def span_ms_per_itr(ctx, name: str) -> float | None:
    return per_itr(ctx, lambda snap: 1e3 * seconds(snap, name))


def span_ms_per_step(ctx, name: str) -> float | None:
    return per_step(ctx, lambda snap: 1e3 * seconds(snap, name))
