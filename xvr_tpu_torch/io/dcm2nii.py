"""DICOM series -> NIfTI conversion (backs ``dcm2nii``).

Counterpart of ``xvr_tpu.io.dcm2nii`` on the port's own DICOM reader and
NIfTI writer: slices are sorted along the normal of ImageOrientationPatient,
intensities rescaled with RescaleSlope/Intercept, and the affine assembled
from orientation, position and spacing, then turned from LPS to RAS.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .dicom import dcmread, pixel_array
from .nifti import save_nifti

_LPS_TO_RAS = np.diag([-1.0, -1.0, 1.0])


def dicom_series_to_nifti(inpath: str | Path, outpath: str | Path) -> Path:
    """Convert a DICOM series (a directory, searched recursively, or one
    file, multiframe or not) into one NIfTI volume -> ``outpath``."""
    inpath = Path(inpath)
    files = sorted(p for p in inpath.rglob("*") if p.is_file()) if inpath.is_dir() else [inpath]

    slices = []
    for f in files:
        try:
            ds = dcmread(f)
        except Exception:  # not a DICOM file: a series directory holds others too
            continue
        if "PixelData" not in ds or "Rows" not in ds:
            continue
        slices.append((f, ds))
    if not slices:
        raise FileNotFoundError(f"No readable DICOM slices under {inpath}")

    iop = slices[0][1].get("ImageOrientationPatient", [1, 0, 0, 0, 1, 0])
    row_dir = np.asarray(iop[:3], dtype=float)
    col_dir = np.asarray(iop[3:], dtype=float)
    normal = np.cross(row_dir, col_dir)

    def position(ds):
        ipp = ds.get("ImagePositionPatient")
        if ipp is None:
            return 0.0
        return float(np.dot(np.asarray(ipp, dtype=float), normal))

    # the affine's origin is the first slice after sorting, not the first read
    slices.sort(key=lambda fs: position(fs[1]))
    first = slices[0][1]

    imgs, zs = [], []
    for _, ds in slices:
        arr = pixel_array(ds).astype(np.float32)
        slope = float(ds.get("RescaleSlope", 1.0) or 1.0)
        inter = float(ds.get("RescaleIntercept", 0.0) or 0.0)
        z0 = position(ds)
        if arr.ndim == 3:
            # a multiframe file: its frames are slices at the file's own frame
            # spacing, one z each, so that the affine's slab step is a frame's
            dzf = float(ds.get("SpacingBetweenSlices", ds.get("SliceThickness", 1.0)) or 1.0)
            for i, frame in enumerate(arr):
                imgs.append(frame * slope + inter)
                zs.append(z0 + i * dzf)
        else:
            imgs.append(arr * slope + inter)
            zs.append(z0)

    vol = np.stack(imgs, axis=-1)  # (rows, cols, slices)
    spacing = first.get("PixelSpacing", first.get("ImagerPixelSpacing", [1.0, 1.0]))
    if not isinstance(spacing, (list, tuple)):
        spacing = [float(spacing)] * 2
    dz = float(first.get("SpacingBetweenSlices", first.get("SliceThickness", 1.0)) or 1.0)
    if len(zs) > 1 and zs[-1] != zs[0]:
        dz = (zs[-1] - zs[0]) / (len(zs) - 1)

    origin = np.asarray(first.get("ImagePositionPatient", [0.0, 0.0, 0.0]), dtype=float)
    # volume axes: axis 0 = rows (col_dir), axis 1 = columns (row_dir), axis 2 = normal
    affine_lps = np.eye(4)
    affine_lps[:3, 0] = col_dir * float(spacing[0])
    affine_lps[:3, 1] = row_dir * float(spacing[1])
    affine_lps[:3, 2] = normal * dz
    affine_lps[:3, 3] = origin
    affine = affine_lps.copy()
    affine[:3] = _LPS_TO_RAS @ affine_lps[:3]

    outpath = Path(outpath)
    outpath.parent.mkdir(parents=True, exist_ok=True)
    save_nifti(outpath, vol, affine)
    return outpath
