"""Carry registration state into the port from plain arrays and values.

The registration path holds no network weights: its state is the CT, the
labelmap, the affine, the detector intrinsics, the projector's renderer
fields and the pose matrices. :func:`from_numpy_state` builds the port's
:class:`~xvr_tpu_torch.render.Volume`, :class:`~xvr_tpu_torch.render.Projector`
and :class:`~xvr_tpu_torch.geometry.RigidTransform` from NumPy arrays and
plain Python values, so any producer of those (a saved bundle, or the fields
of another implementation's projector) can hand its state over.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import Detector, RigidTransform
from .render.projector import Projector
from .render.volume import Volume, transform_hu_to_density


def from_numpy_state(
    data,
    affine,
    *,
    detector: dict,
    mask=None,
    orientation: str | None = "AP",
    density=None,
    renderer: str = "trilinear",
    labels=None,
    n_samples: int = 256,
    voxel_shift: float = 0.0,
    pallas_perm=None,
    pallas_window: int = 32,
    pallas_remap: bool = False,
    shearwarp_window: int = 48,
    shearwarp_grid=None,
    shearwarp_remap: bool = False,
    pose=None,
    device="cuda",
) -> tuple[Projector, Volume, RigidTransform | None]:
    """-> (projector, volume, pose or None), all on ``device``.

    ``data`` (nx, ny, nz) intensities, ``affine`` (4, 4) voxel -> world mm,
    ``mask`` an optional integer labelmap (rendered as channels when
    ``labels`` names some of its values), ``density`` the attenuation grid
    (computed from ``data`` by the HU transfer when omitted), ``detector`` a
    dict of :class:`~xvr_tpu_torch.geometry.Detector` fields and ``pose``
    optional (B, 4, 4) or (4, 4) matrices."""

    def t(x, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(x)), dtype=dtype, device=device)

    volume = Volume(
        data=t(data),
        affine=t(affine, torch.float32),
        mask=None if mask is None else t(mask, torch.int32),
        orientation=orientation,
    )
    dens = transform_hu_to_density(volume.data) if density is None else t(density, torch.float32)
    det = Detector(**{k: v for k, v in detector.items()})
    projector = Projector(
        volume=volume,
        density=dens,
        detector=det,
        renderer=str(renderer),
        labels=None if labels is None else tuple(int(x) for x in labels),
        n_samples=int(n_samples),
        voxel_shift=float(voxel_shift),
        pallas_perm=None if pallas_perm is None else tuple(int(p) for p in pallas_perm),
        pallas_window=int(pallas_window),
        pallas_remap=bool(pallas_remap),
        shearwarp_window=int(shearwarp_window),
        shearwarp_grid=None if shearwarp_grid is None else tuple(int(x) for x in shearwarp_grid),
        shearwarp_remap=bool(shearwarp_remap),
    )
    rt = None if pose is None else RigidTransform(t(pose, torch.float32))
    return projector, volume, rt
