"""Host waits on the device per training step: the program's counter
``host_syncs`` (device-to-host reads and synchronizing copies) over the
traced window's steps."""

from portbench.spans import per_step


def read(ctx):
    return per_step(ctx, lambda snap: snap["counters"].get("host_syncs", 0))
