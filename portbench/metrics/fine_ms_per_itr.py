"""Milliseconds per registrar iteration at the pyramid's finest stage over
the traced window: the stage seconds of ``RegistrarBase.stage_log`` over
its iterations (``n_done``), summed over the stages whose detector height is
the finest stage's, in every pass of every request."""


def read(ctx):
    dets = ctx.get("stage_dets") or []
    if not dets:
        return None
    fine = max(d.height for d in dets)
    stages = [st for req in ctx.get("requests", []) for st in req["stages"]
              if st["height"] == fine]
    n = sum(st["n_done"] for st in stages)
    return 1e3 * sum(st["seconds"] for st in stages) / n if n else None
