"""Host milliseconds per registrar iteration in the span
``register.exit_check`` (self time): the host blocked on the device until
it tells whether any image still runs. From the program's spans over the
traced window."""

from portbench.spans import span_ms_per_itr


def read(ctx):
    return span_ms_per_itr(ctx, "register.exit_check")
