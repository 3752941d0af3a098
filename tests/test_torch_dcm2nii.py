"""DICOM series -> NIfTI (``xvr_tpu_torch.io.dcm2nii``) against the JAX
package's converter (CPU).

Mirrors tests/test_dcm2nii.py: a shuffled series is sorted along the
orientation normal, rescaled with RescaleSlope/Intercept and given its
LPS -> RAS affine; multiframe files contribute one slice per frame at the
frame spacing. Each case holds the port's NIfTI volume and affine equal to
the JAX package's output for the same files.
"""

from pathlib import Path

import numpy as np
import pytest

from xvr_tpu.io.dcm2nii import dicom_series_to_nifti as j_dicom_series_to_nifti
from xvr_tpu_torch.io import dcmwrite, load_nifti
from xvr_tpu_torch.io.dcm2nii import dicom_series_to_nifti
from torch_threads import two_torch_threads  # noqa: F401

ROWS, COLS, SLICES = 16, 12, 8
SP_ROW, SP_COL, DZ = 1.5, 2.0, 3.0


def _write_series(d: Path, iop=(1, 0, 0, 0, 1, 0), slope=1.0):
    """tests/test_dcm2nii.py's CT-like series (HU stored as uint16 with
    intercept -1024), written in shuffled order, along the normal of
    ``iop``."""
    rng = np.random.default_rng(0)
    hu = rng.integers(-1000, 1500, size=(ROWS, COLS, SLICES)).astype(np.float32)
    origin = np.array([5.0, -7.0, 11.0])
    normal = np.cross(iop[:3], iop[3:])
    for k in rng.permutation(SLICES):
        stored = ((hu[:, :, k] + 1024.0) / slope).astype(np.uint16)
        pos = origin + DZ * k * normal
        extra = [
            (0x0020, 0x0032, b"DS", [f"{v:g}" for v in pos]),
            (0x0020, 0x0037, b"DS", [f"{v:g}" for v in iop]),
            (0x0028, 0x1052, b"DS", "-1024"),
            (0x0028, 0x1053, b"DS", f"{slope:g}"),
            (0x0018, 0x0050, b"DS", f"{DZ:g}"),
        ]
        dcmwrite(d / f"slice_{SLICES - k:03d}.dcm", stored, sdd=0.0, row_spacing=SP_ROW,
                 col_spacing=SP_COL, extra=extra)
    (d / "notes.txt").write_text("not a DICOM file")
    return hu, origin


def _both(d: Path):
    got = load_nifti(dicom_series_to_nifti(d, d / "out" / "port.nii.gz"))
    ref = load_nifti(j_dicom_series_to_nifti(d, d / "out" / "jax.nii.gz"))
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    return got


@pytest.mark.parametrize("iop, slope", [
    ((1, 0, 0, 0, 1, 0), 1.0),  # axial
    ((0, 1, 0, 0, 0, -1), 2.0),  # sagittal, with a rescale slope
])
def test_series_sorts_rescales_and_orients_like_jax(tmp_path, iop, slope):
    hu, origin = _write_series(tmp_path, iop, slope)
    data, affine = _both(tmp_path)
    assert data.shape == (ROWS, COLS, SLICES)
    np.testing.assert_allclose(data, hu, atol=slope)
    # axis 0 = rows (col_dir), axis 1 = columns (row_dir), axis 2 = normal; LPS -> RAS
    ras = np.diag([-1.0, -1.0, 1.0])
    expect = np.eye(4)
    expect[:3, 0] = ras @ np.asarray(iop[3:], float) * SP_ROW
    expect[:3, 1] = ras @ np.asarray(iop[:3], float) * SP_COL
    expect[:3, 2] = ras @ np.cross(iop[:3], iop[3:]) * DZ
    expect[:3, 3] = ras @ origin
    np.testing.assert_allclose(affine, expect, atol=1e-6)


def test_multiframe_frame_spacing_like_jax(tmp_path):
    """Two 4-frame files at z=0 and z=4 with 1 mm frame spacing make an
    8-slice volume with a 1 mm slab step."""
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 4000, size=(4, 8, 8)).astype(np.uint16) for _ in range(2)]
    for name, arr, z in (("b.dcm", frames[1], 4.0), ("a.dcm", frames[0], 0.0)):
        extra = [
            (0x0020, 0x0032, b"DS", ["0", "0", f"{z:g}"]),
            (0x0020, 0x0037, b"DS", ["1", "0", "0", "0", "1", "0"]),
            (0x0018, 0x0088, b"DS", "1"),  # SpacingBetweenSlices, per frame
        ]
        dcmwrite(tmp_path / name, arr, sdd=0.0, row_spacing=1.0, col_spacing=1.0, extra=extra)
    data, affine = _both(tmp_path)
    assert data.shape == (8, 8, 8)
    np.testing.assert_allclose(affine[2, 2], 1.0, atol=1e-6)
    np.testing.assert_array_equal(data[:, :, 0], frames[0][0].astype(np.float32))
    np.testing.assert_array_equal(data[:, :, 4], frames[1][0].astype(np.float32))


def test_no_slices_raises(tmp_path):
    (tmp_path / "notes.txt").write_text("not a DICOM file")
    with pytest.raises(FileNotFoundError, match="No readable DICOM slices"):
        dicom_series_to_nifti(tmp_path, tmp_path / "ct.nii.gz")
