"""Host milliseconds per training step in the span ``train.optim`` (self
time): the AGC-Adam step. From the program's spans over the traced window."""

from portbench.spans import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "train.optim")
