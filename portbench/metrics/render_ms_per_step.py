"""Host milliseconds per training step in the span ``train.render`` (self
time): the density map of the step's subject, its label stack's pack and
both renders (K1/K2); on a padded subject the padding is marched here. From
the program's spans over the traced window; the reader of every training
cell without one of its own."""

from portbench.spans import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "train.render")
