"""Host milliseconds per training step in the span ``train.loss`` (self time):
the loss and its inputs. From the program's spans over the traced window;
the reader of every training cell without one of its own."""

from portbench.spans import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "train.loss")
