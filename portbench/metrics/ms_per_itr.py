"""Milliseconds per registrar iteration over the traced window: the stage
seconds of ``RegistrarBase.stage_log`` over its iterations (``n_done``),
summed over every stage of every pass."""

from portbench.counts import window_work


def read(ctx):
    w = window_work(ctx)
    return 1e3 * w["seconds"] / w["n_done"] if w["n_done"] else None
