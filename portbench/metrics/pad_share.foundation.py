"""The share of the voxels the training steps marched that are padding (%):
the program's counters ``train.pad_voxels`` over ``train.volume_voxels``
over the traced window (each step's subject, padded to the largest
subject's shape). A program without the counters reads nothing."""

from portbench.spans import snapshot


def read(ctx):
    snap = snapshot() if ctx.get("steps") else None
    if snap is None or not snap["counters"].get("train.volume_voxels"):
        return None
    counters = snap["counters"]
    return 100.0 * counters.get("train.pad_voxels", 0) / counters["train.volume_voxels"]
