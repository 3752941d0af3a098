"""Projector construction facade: counterpart of
``xvr_tpu.render.load.initialize_drr``."""

from __future__ import annotations

from .projector import Projector


def initialize_drr(
    volume,
    mask,
    labels,
    orientation,
    height,
    width,
    sdd,
    delx,
    dely,
    x0,
    y0,
    reverse_x_axis,
    renderer,
    read_kwargs=None,
    drr_kwargs=None,
    device="cuda",
) -> Projector:
    """Load a CT (+ optional labelmap restricted to ``labels``) onto
    ``device`` and build a projector at the given intrinsics. Labels act at
    read level (density outside them becomes air); the projector renders one
    image per pose."""
    from ..io.volumes import read

    vol = read(volume, mask, labels=labels, orientation=orientation, device=device,
               **(read_kwargs or {}))
    drr_kwargs = dict(drr_kwargs or {})
    return Projector.from_volume(
        vol,
        sdd=sdd,
        height=height,
        width=width,
        delx=delx,
        dely=dely,
        x0=x0,
        y0=y0,
        reverse_x_axis=reverse_x_axis,
        renderer=renderer,
        labels=None,
        voxel_shift=drr_kwargs.get("voxel_shift", 0.0),
    )
