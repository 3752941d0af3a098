"""Host milliseconds per registrar iteration in the span
``register.backward`` (self time): the backward of the render and the
similarity (`torch.autograd.grad`, K3/K4). From the program's spans over
the traced window."""

from portbench.spans import span_ms_per_itr


def read(ctx):
    return span_ms_per_itr(ctx, "register.backward")
