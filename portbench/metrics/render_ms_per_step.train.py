"""Host milliseconds per training step in the span ``train.render`` (self
time): the density map, the label stacks' pack and both renders (K1/K2).
From the program's spans over the traced window."""

from portbench.spans import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "train.render")
