"""Learning-rate schedules as plain ``step -> lr`` callables: counterpart of
``xvr_tpu.train.schedule``, equal at every integer step to
``optax.warmup_cosine_decay_schedule(0, lr, warmup, total, 0)`` and
``optax.constant_schedule(lr)``. They are evaluated in float32, as optax
evaluates them."""

from __future__ import annotations

import numpy as np


def warmup_cosine_schedule(lr: float, warmup_steps, total_steps):
    """Linear warmup from 0 to ``lr`` over ``warmup_steps``, then a cosine
    decay to 0 at ``total_steps`` (steps are updates, counted from 0), with
    optax's float32 operations in optax's order."""
    warmup = max(int(warmup_steps), 1)
    total = max(int(total_steps), warmup + 1)
    f = np.float32
    peak, decay = f(lr), total - warmup

    def schedule(step) -> float:
        step = int(step)
        if step < warmup:
            frac = f(1.0) - f(max(step, 0)) / f(warmup)
            return float(f(-lr) * frac + peak)
        t = f(min(step - warmup, decay))
        cosine = f(0.5) * (f(1.0) + f(np.cos(np.float64(f(np.pi) * t / f(decay)))))
        return float(peak * cosine)

    return schedule


def identity_schedule(lr: float):
    """A constant learning rate."""
    return lambda step: lr
