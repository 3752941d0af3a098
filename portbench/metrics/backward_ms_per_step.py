"""Host milliseconds per training step in the span ``train.backward`` (self
time): the backward through the loss, the re-render (K3/K4) and the CNN.
From the program's spans over the traced window; the reader of every
training cell without one of its own."""

from portbench.spans import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "train.backward")
