"""Host milliseconds per training step in the span ``train.augment`` (self
time): the foreground and keep masks, the augmentations and the CNN's input
transform. From the program's spans over the traced window; the reader of
every training cell without one of its own."""

from portbench.spans import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "train.augment")
