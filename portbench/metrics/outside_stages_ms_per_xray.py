"""Host milliseconds per X-ray outside the pyramid stages: the spans
``register.request`` and ``register.save`` less ``register.stage`` (the
X-ray's read, seeding, restart selection and bundle writing), over the
X-rays registered in the traced window."""

from portbench.spans import seconds, snapshot, window_xrays


def read(ctx):
    snap, n = snapshot(), window_xrays(ctx)
    if snap is None or not n:
        return None
    s = sum(seconds(snap, k, self_time=False) for k in ("register.request", "register.save"))
    return 1e3 * (s - seconds(snap, "register.stage", self_time=False)) / n
