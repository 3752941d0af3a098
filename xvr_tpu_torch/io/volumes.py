"""Volume loading: NIfTI -> :class:`xvr_tpu_torch.render.Volume`.

Counterpart of ``xvr_tpu.io.volumes.read``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..render.volume import Volume
from .nifti import load_nifti, to_canonical


def read(
    volpath: str | Path,
    maskpath: str | Path | None = None,
    labels=None,
    orientation: str | None = "AP",
    canonical: bool = True,
    device="cuda",
) -> Volume:
    """Load a CT/MR volume (+ optional labelmap) onto ``device``.

    ``labels`` (list of ints or a "1,2,3" string) restricts the labelmap to
    those labels (others -> 0), and the density outside them becomes air.
    """
    data, affine = load_nifti(volpath)
    if canonical:
        data, affine = to_canonical(data, affine)

    mask = None
    if maskpath is not None:
        mdata, maffine = load_nifti(maskpath)
        if canonical:
            mdata, maffine = to_canonical(mdata, maffine)
        if mdata.shape != data.shape:
            raise ValueError(
                f"mask shape {mdata.shape} does not match volume shape {data.shape}"
            )
        mdata = np.rint(mdata).astype(np.int32)
        if labels is not None:
            labels = parse_labels(labels)
            keep = np.isin(mdata, labels)
            mdata = np.where(keep, mdata, 0)
            data = np.where(keep, data, -1000.0).astype(np.float32)
        mask = torch.as_tensor(mdata, device=device)

    return Volume(
        data=torch.as_tensor(np.ascontiguousarray(data), device=device),
        affine=torch.as_tensor(np.asarray(affine, np.float32), device=device),
        mask=mask,
        orientation=orientation,
    )


def parse_labels(labels) -> list[int]:
    if labels is None:
        return []
    if isinstance(labels, str):
        return [int(x) for x in labels.split(",") if x.strip()]
    return [int(x) for x in labels]
