"""Host milliseconds per registrar iteration in the span
``register.similarity`` (self time): the X-ray transform and the
similarity (mNCC and gNCC). From the program's spans over the traced
window."""

from portbench.spans import span_ms_per_itr


def read(ctx):
    return span_ms_per_itr(ctx, "register.similarity")
