"""Host waits on the device per training step: the program's counter
``host_syncs`` (device-to-host reads and synchronizing copies) over the
traced window's steps; the reader of every training cell without one of
its own."""

from portbench.spans import per_step


def read(ctx):
    return per_step(ctx, lambda snap: snap["counters"].get("host_syncs", 0))
