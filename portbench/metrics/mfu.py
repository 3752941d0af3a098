"""The whole registration's share of the card's float32 peak (%): the
operations its work needs, counted from shapes (K1-K4 and the similarity,
forward and backward, :func:`portbench.counts.stage_work`), over the traced
window's wall time, against 67 TFLOP/s."""

from portbench.counts import F32, window_work


def read(ctx):
    w = window_work(ctx)
    return 100.0 * w["ops"] / ctx["window_s"] / F32 if w["ops"] else None
