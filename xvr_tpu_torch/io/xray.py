"""X-ray DICOM reading and preprocessing.

Counterpart of ``xvr_tpu.io.xray``: parse pixels and the imaging system's
intrinsics (sdd, pixel spacing, detector origin), flip RAO posterior-foot
studies to anterior-foot, then preprocess: centre-crop the collimator border,
min-max rescale, optional mode-background subtraction, optional
exponential->linear conversion ``log(max) - log(img + 1)``, and multiframe
reduction (max/sum/index/callable). Host-side NumPy; the image is returned
as a float32 array and moved to the device by the caller.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..geometry import RigidTransform, convert
from .dicom import dcmread, pixel_array


def read_xray(
    filename: str | Path,
    crop: int = 0,
    subtract_background: bool = False,
    linearize: bool = True,
    reducefn: str | int | Callable | None = "max",
):
    """-> (img (1, 1, H, W) float32 NumPy, sdd, delx, dely, x0, y0, pf_to_af)."""
    img, sdd, delx, dely, x0, y0, pf_to_af = _parse_dicom(filename)
    img = _preprocess_xray(img, crop, subtract_background, linearize, reducefn)
    return img, sdd, delx, dely, x0, y0, pf_to_af


def _parse_intrinsics(ds):
    """(sdd, delx, dely, x0, y0) from header tags alone — no pixel decode."""
    sdd = float(ds.DistanceSourceToDetector)
    spacing = ds.get("PixelSpacing", ds.get("ImagerPixelSpacing"))
    if spacing is None:
        raise AttributeError("Cannot find pixel spacing in DICOM file")
    if isinstance(spacing, (list, tuple)):
        dely, delx = float(spacing[0]), float(spacing[1])
    else:
        dely = delx = float(spacing)
    origin = ds.get("DetectorActiveOrigin", [0.0, 0.0])
    if isinstance(origin, (list, tuple)):
        y0, x0 = float(origin[0]), float(origin[1])
    else:
        y0, x0 = float(origin), 0.0
    return sdd, delx, dely, x0, y0


def dicom_group_key(filename):
    """Batching key (pixel shape, sdd, spacing, detector origin) read from
    the DICOM header tags only, without decoding the pixels."""
    ds = dcmread(filename)
    frames = int(ds.get("NumberOfFrames", 1) or 1)
    rows, cols = int(ds["Rows"]), int(ds["Columns"])
    shape = (1, 1, frames, rows, cols) if frames > 1 else (1, 1, rows, cols)
    return (shape, *_parse_intrinsics(ds))


def _parse_dicom(filename):
    ds = dcmread(filename)
    img = pixel_array(ds).astype(np.float32)[None, None]  # (1, 1, [T,] H, W)
    sdd, delx, dely, x0, y0 = _parse_intrinsics(ds)
    # reorient RAO from posterior-foot (PF) to anterior-foot (AF)
    pf_to_af = False
    po = ds.get("PatientOrientation")
    ppa = ds.get("PositionerPrimaryAngle")
    if po == ["P", "F"] and ppa is not None and float(ppa) < 0:
        img = img[..., ::-1].copy()
        pf_to_af = True
    return img, sdd, delx, dely, x0, y0, pf_to_af


def parse_dicom_pose(filename, orientation: str | None = "AP", device="cuda") -> RigidTransform:
    """Initial pose from the DICOM positioner angles."""
    ds = dcmread(filename)
    multiplier = -1.0 if orientation == "PA" else 1.0
    alpha = float(ds.PositionerPrimaryAngle)
    beta = float(ds.PositionerSecondaryAngle)
    sid = multiplier * float(ds.DistanceSourceToPatient)
    return convert(
        torch.tensor([[alpha, beta, 0.0]], device=device),
        torch.tensor([[0.0, sid, 0.0]], device=device),
        parameterization="euler_angles",
        convention="ZXY",
        degrees=True,
    )


def _center_crop_np(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    H, W = img.shape[-2:]
    top = max((H - out_h) // 2, 0)
    left = max((W - out_w) // 2, 0)
    return img[..., top : top + out_h, left : left + out_w]


def _preprocess_xray(img, crop, subtract_background, linearize, reducefn):
    if crop != 0:
        H, W = img.shape[-2:]
        img = _center_crop_np(img, H - crop, W - crop)

    img = (img - img.min()) / (img.max() - img.min() + 1e-6)

    if subtract_background:
        # subtract the mode intensity (most frequent value)
        vals, counts = np.unique(img.reshape(-1), return_counts=True)
        img = img - vals[np.argmax(counts)]
        img = np.clip(img, -1, 0) + 1  # restrict to [0, 1]

    if linearize:
        img = img + 1.0
        img = np.log(img.max()) - np.log(img)

    if img.ndim == 5:  # (1, 1, T, H, W) multiframe
        if isinstance(reducefn, str) and reducefn.lstrip("-").isdigit():
            reducefn = int(reducefn)  # the CLI passes frame indices as strings
        if reducefn == "max":
            img = img.max(axis=2)
        elif reducefn == "sum":
            img = img.sum(axis=2)
        elif isinstance(reducefn, int):
            img = img[:, :, reducefn]
        elif callable(reducefn):
            img = reducefn(img)
        elif reducefn is not None:
            raise ValueError(f"Unrecognized reducefn: {reducefn}")

    return img.astype(np.float32)
