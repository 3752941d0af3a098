"""Host milliseconds per registrar iteration in the span ``register.render``
(self time): the render glue: the pose's conversion and the render call
(K1/K2 launches, rays, the warp). From the program's spans over the traced
window."""

from portbench.spans import span_ms_per_itr


def read(ctx):
    return span_ms_per_itr(ctx, "register.render")
