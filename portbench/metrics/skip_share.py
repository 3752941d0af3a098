"""The share of the shear-warp march's (tile, slab) pairs that K1 and K4
skipped because the tile's staged box misses the slab's content (%): the
program's device counters ``shearwarp.slabs_skipped`` over
``shearwarp.slabs_marched`` + ``shearwarp.slabs_skipped``, over the window.
Slabs that w_k or the volume's bounds skip are in neither. Nothing where the
program has no such counters, or ran no K1/K4 block."""

from portbench.spans import snapshot


def read(ctx):
    snap = snapshot()
    if snap is None or "shearwarp.slabs_skipped" not in snap["counters"]:
        return None
    skipped = snap["counters"]["shearwarp.slabs_skipped"]
    total = snap["counters"].get("shearwarp.slabs_marched", 0) + skipped
    return 100.0 * skipped / total if total else None
