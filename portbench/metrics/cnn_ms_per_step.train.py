"""Host milliseconds per training step in the span ``train.cnn`` (self time):
the CNN's forward, the pose decode and the reframe. From the program's
spans over the traced window."""

from portbench.spans import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "train.cnn")
