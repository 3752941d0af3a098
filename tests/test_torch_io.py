"""The port's IO against the JAX package's on the same files (CPU).

NIfTI and DICOM round trips through the port's own copies of the readers
and writers, files written by one package read by the other, and
``read_xray`` on the same file with every preprocessing option: all exact
(both are the same NumPy code on the same bytes).
"""

import numpy as np
import pytest
import torch

from xvr_tpu.io import dcmread as j_dcmread
from xvr_tpu.io import dcmwrite as j_dcmwrite
from xvr_tpu.io import read as j_read
from xvr_tpu.io import read_xray as j_read_xray
from xvr_tpu.io import save_nifti as j_save_nifti
from xvr_tpu.io.xray import dicom_group_key as j_group_key
from xvr_tpu.io.xray import parse_dicom_pose as j_parse_pose
from xvr_tpu_torch.io import (
    dcmread,
    dcmwrite,
    dicom_group_key,
    load_nifti,
    parse_dicom_pose,
    pixel_array,
    read,
    read_xray,
    save_nifti,
)
from torch_threads import two_torch_threads  # noqa: F401


@pytest.mark.parametrize("name", ["vol.nii", "vol.nii.gz"])
def test_nifti_roundtrip_and_cross_read(tmp_path, name):
    rng = np.random.default_rng(0)
    data = rng.normal(size=(8, 10, 12)).astype(np.float32)
    affine = np.array([[2.0, 0, 0, -8.0], [0, 1.5, 0, -7.5], [0, 0, 1.0, -6.0], [0, 0, 0, 1.0]])
    save_nifti(tmp_path / name, data, affine)
    d2, a2 = load_nifti(tmp_path / name)
    np.testing.assert_array_equal(d2, data)
    np.testing.assert_allclose(a2, affine, rtol=1e-6)
    # a file the JAX package wrote reads identically through the port
    j_save_nifti(tmp_path / ("j" + name), data, affine)
    v_t = read(tmp_path / ("j" + name), device="cpu")
    v_j = j_read(tmp_path / ("j" + name))
    np.testing.assert_array_equal(v_t.data.numpy(), np.asarray(v_j.data))
    np.testing.assert_array_equal(v_t.affine.numpy(), np.asarray(v_j.affine))


def test_read_with_mask_and_labels_matches_jax(tmp_path):
    data = (np.random.default_rng(0).normal(size=(6, 6, 6)) * 100).astype(np.float32)
    mask = np.zeros((6, 6, 6), dtype=np.float32)
    mask[:3] = 1
    mask[3:, :3] = 2
    mask[3:, 3:, :3] = 7
    save_nifti(tmp_path / "vol.nii.gz", data, np.eye(4))
    save_nifti(tmp_path / "mask.nii.gz", mask, np.eye(4))
    v = read(tmp_path / "vol.nii.gz", tmp_path / "mask.nii.gz", labels="1,7", device="cpu")
    vj = j_read(tmp_path / "vol.nii.gz", tmp_path / "mask.nii.gz", labels="1,7")
    np.testing.assert_array_equal(v.mask.numpy(), np.asarray(vj.mask))
    np.testing.assert_array_equal(v.data.numpy(), np.asarray(vj.data))
    assert v.mask.device.type == "cpu" and v.data.device.type == "cpu"


# positioner angles (12, -4) degrees and a 700 mm source-to-patient distance
POSITIONER = [(0x0018, 0x1510, b"DS", "12"), (0x0018, 0x1511, b"DS", "-4"),
              (0x0018, 0x1111, b"DS", "700")]


@pytest.fixture()
def xray_file(tmp_path):
    img = np.random.default_rng(0).uniform(0, 4000, size=(32, 48)).astype(np.uint16)
    p = tmp_path / "xray.dcm"
    dcmwrite(p, img, sdd=1020.0, row_spacing=0.194, col_spacing=0.2,
             row_origin=1.5, col_origin=-2.5,
             extra=POSITIONER)
    return p, img


def test_dicom_roundtrip_and_cross_read(xray_file, tmp_path):
    p, img = xray_file
    ds = dcmread(p)
    assert int(ds.Rows) == 32 and int(ds.Columns) == 48
    np.testing.assert_array_equal(pixel_array(ds), img)
    # the JAX package's writer and reader agree byte for byte with the port's
    j_dcmwrite(tmp_path / "j.dcm", img, sdd=1020.0, row_spacing=0.194, col_spacing=0.2,
               row_origin=1.5, col_origin=-2.5,
               extra=POSITIONER)
    assert (tmp_path / "j.dcm").read_bytes() == p.read_bytes()
    assert dict(j_dcmread(p)).keys() == dict(ds).keys()
    assert dicom_group_key(p) == j_group_key(p)


@pytest.mark.parametrize("crop,subtract_background,linearize", [
    (0, False, False), (4, False, True), (6, True, True), (0, True, False),
])
def test_read_xray_matches_jax(xray_file, crop, subtract_background, linearize):
    p, _ = xray_file
    got = read_xray(p, crop, subtract_background, linearize, "max")
    ref = j_read_xray(p, crop, subtract_background, linearize, "max")
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    assert got[1:] == tuple(ref[1:])


def test_read_xray_multiframe_matches_jax(tmp_path):
    frames = np.stack([np.full((8, 8), i * 100, np.uint16) for i in range(3)])
    frames[1, 2:5, 3:6] = 900
    p = tmp_path / "mf.dcm"
    dcmwrite(p, frames, sdd=1000.0, row_spacing=1.0, col_spacing=1.0)
    for reducefn in ("max", "sum", 0, "2"):
        got = read_xray(p, linearize=False, reducefn=reducefn)[0]
        ref = np.asarray(j_read_xray(p, linearize=False, reducefn=reducefn)[0])
        np.testing.assert_array_equal(got, ref)


def test_parse_dicom_pose_matches_jax(xray_file):
    p, _ = xray_file
    for orientation in ("AP", "PA"):
        got = parse_dicom_pose(p, orientation, device="cpu").matrix
        ref = np.asarray(j_parse_pose(p, orientation).matrix)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-4)
        assert got.dtype == torch.float32
