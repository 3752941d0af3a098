"""The training step's share of the card's peak (%): the operations its
work needs (ResNet-34 forward and backward at the batch, and K1-K4), counted
from shapes, over the traced window's wall time, against the peak of the
precision the convolutions run in: TF32 (495 TFLOP/s) when cuDNN may use it,
else float32 (67 TFLOP/s)."""

from portbench.counts import PEAKS, train_step_work


def read(ctx):
    if not ctx.get("steps"):
        return None
    peak = PEAKS["tf32_flops"] if ctx["conv_tf32"] else PEAKS["f32_flops"]
    return 100.0 * ctx["steps"] * train_step_work(ctx)["ops"] / ctx["window_s"] / peak
