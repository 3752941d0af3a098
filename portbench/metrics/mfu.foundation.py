"""The foundation steps' share of the card's peak (%): the operations their
work needs (ResNet-34 forward and backward at the batch, and K1-K4 on each
step's subject at its own shape), counted from shapes, over the traced
window's wall time, against the peak of the precision the convolutions run
in, as ``mfu.train`` counts: TF32 when cuDNN may use it, else float32."""

from portbench.counts import PEAKS
from portbench.counts_foundation import window_work


def read(ctx):
    if not ctx.get("steps"):
        return None
    work = window_work(ctx)
    if work is None:
        return None
    peak = PEAKS["tf32_flops"] if ctx["conv_tf32"] else PEAKS["f32_flops"]
    return 100.0 * work["ops"] / ctx["window_s"] / peak
