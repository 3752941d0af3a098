"""Host milliseconds per registrar iteration in the span ``register.update``
(self time): Adam, the freeze, argmax tracking, the scheduler, the plateau
machine and the trajectory record. From the program's spans over the
traced window."""

from portbench.spans import span_ms_per_itr


def read(ctx):
    return span_ms_per_itr(ctx, "register.update")
