"""The share of the registrar's iterations that ran as one replay of a CUDA
graph (%): the program's counter ``register.graph_replays`` over
``register.iterations``. Nothing where the program has no such counter."""

from portbench.spans import per_itr, snapshot


def read(ctx):
    snap = snapshot()
    if snap is None or "register.graph_replays" not in snap["counters"]:
        return None
    share = per_itr(ctx, lambda s: s["counters"]["register.graph_replays"])
    return None if share is None else 100.0 * share
