"""Host milliseconds per training step in the span ``train.cnn`` (self time):
the CNN's forward, the pose decode and the reframe. From the program's spans
over the traced window; the reader of every training cell without one of its
own."""

from portbench.spans import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "train.cnn")
