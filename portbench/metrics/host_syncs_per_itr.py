"""Host waits on the device per registrar iteration: the program's counter
``host_syncs`` (device-to-host reads and synchronizing copies, wherever in
the window they fall) over ``register.iterations``."""

from portbench.spans import per_itr


def read(ctx):
    return per_itr(ctx, lambda snap: snap["counters"].get("host_syncs", 0))
