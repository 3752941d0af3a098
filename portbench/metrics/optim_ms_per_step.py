"""Host milliseconds per training step in the span ``train.optim`` (self time):
the gradient folded into the running mean on every step, AGC and Adam on one
step in ``n_grad_accum_itrs``, both kinds of step together. From the
program's spans over the traced window; the reader of every training cell
without one of its own."""

from portbench.spans import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "train.optim")
