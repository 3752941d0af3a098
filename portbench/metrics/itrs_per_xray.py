"""Registrar iterations per X-ray over the traced window: ``n_done`` of
``RegistrarBase.stage_log`` summed over stages and passes, over the X-rays
registered (a batched stage runs until its slowest X-ray stops)."""

from portbench.counts import window_work


def read(ctx):
    w = window_work(ctx)
    return w["n_done"] / w["xrays"] if w["xrays"] else None
