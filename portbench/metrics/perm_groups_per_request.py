"""Optimizations per request over the traced window: the program's counter
``register.perm_groups`` (one per batched optimization a ``run_batch``
runs, one per march axis of its X-rays) over the client's requests.
Nothing where the program has no such counter."""

from portbench.spans import snapshot


def read(ctx):
    snap = snapshot()
    n = ctx.get("client_requests")
    if snap is None or not n or "register.perm_groups" not in snap["counters"]:
        return None
    return snap["counters"]["register.perm_groups"] / n
