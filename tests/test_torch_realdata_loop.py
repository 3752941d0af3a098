"""The real-data loop on the port (CPU), the twin of tests/test_realdata_loop.py.

The miniature DeepFluoro-format HDF5 of tests/test_realdata_loop.py (a 64^3
bony phantom, a 128^2 X-ray stored upside down with its pose before the
mapper, an off-centre principal point) goes through the port's
``scripts/torch/convert_datasets.py``, then ``register fixed`` on the port's
CLI with ``--device cpu`` (the JAX test's scales, iterations and rates from
one start without a re-anneal, a tenth of the default's work), then
``scripts/torch/evaluate.py``, and lands sub-mm on the known pose. The port's converted tree holds what the JAX
script's holds on the same HDF5 (NIfTI data and affine, DICOM pixels and
intrinsics tags, npz keys and values, all exactly), and
``scripts/torch/validate_convention.py`` renders, transforms and scores the
same tree as the JAX script: the DRR and the transformed X-ray within 1e-4
of their largest value, gNCC within 1e-4 (both render with the golden
trilinear marcher in float32). mNCC agrees within MNCC_ATOL only: its local
term averages 9x9 patches, and on this fixture 12% of them lie on flat
background, where the one-pass variance ``E[x^2] - E[x]^2`` is float32
cancellation noise against the 1e-6 floor in both packages (the local term
moves by 0.07 between float32 and float64 on the same images), so the two
packages' sums in their own order give mNCC 0.0199 apart. On the same CT
with its air filled by graded soft tissue, and an X-ray of it, neither image
has a flat patch, and there mNCC agrees within NCC_ATOL.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from test_realdata_loop import X0, Y0, _convert_fixture  # noqa: E402

import torch  # noqa: E402

from xvr_tpu.io import dcmread as j_dcmread  # noqa: E402
from xvr_tpu.io import pixel_array as j_pixel_array  # noqa: E402
from xvr_tpu.io import read_xray as j_read_xray  # noqa: E402
from xvr_tpu.render.load import initialize_drr as j_initialize_drr  # noqa: E402
from xvr_tpu.utils.transforms import make_xray_transforms as j_transforms  # noqa: E402
from xvr_tpu_torch.cli import main as port_main  # noqa: E402
from xvr_tpu_torch.io import (  # noqa: E402
    dcmread, dcmwrite, load_nifti, pixel_array, read_xray, save_nifti)
from xvr_tpu_torch.render.load import initialize_drr  # noqa: E402
from xvr_tpu_torch.utils.transforms import make_xray_transforms  # noqa: E402
from torch_threads import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
NCC_ATOL = 1e-4
MNCC_ATOL = 0.05  # the flat patches' float32 noise, above


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """The fixture converted by both scripts. -> (JAX tree's subject dir,
    the port's data root, its subject dir, the fixture's GT values)."""
    tmp = tmp_path_factory.mktemp("trealdata")
    data_root, subject, gt_pose, gt_rot, gt_xyz, _, mapper, _ = _convert_fixture(tmp)
    conv = _load(REPO / "scripts" / "torch" / "convert_datasets.py", "torch_convert_datasets")
    port_root = tmp / "data_torch"
    assert conv.main(["deepfluoro", str(tmp / "mini_deepfluoro.h5"), "-o", str(port_root)]) == 0
    port_subject = port_root / "deepfluoro" / "subject01"
    return subject, port_root, port_subject, (np.asarray(gt_pose.matrix), gt_rot, gt_xyz, mapper)


def test_converted_tree_equals_the_jax_scripts(converted):
    jsub, _, tsub, _ = converted
    names = lambda d: sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())  # noqa: E731
    assert names(tsub) == names(jsub) == [
        "fiducials.npy", "mask.nii.gz", "volume.nii.gz", "xrays/000.dcm", "xrays/000.npz"]
    for name in ("volume.nii.gz", "mask.nii.gz"):
        (td, ta), (jd, ja) = load_nifti(tsub / name), load_nifti(jsub / name)
        assert td.dtype == jd.dtype and np.array_equal(td, jd) and np.array_equal(ta, ja)
    ds, jds = dcmread(tsub / "xrays" / "000.dcm"), j_dcmread(jsub / "xrays" / "000.dcm")
    assert np.array_equal(pixel_array(ds), j_pixel_array(jds))
    for tag in ("DistanceSourceToDetector", "PixelSpacing", "DetectorActiveOrigin", "Rows",
                "Columns"):
        assert ds.get(tag) == jds.get(tag), tag
    t, j = np.load(tsub / "xrays" / "000.npz"), np.load(jsub / "xrays" / "000.npz")
    assert sorted(t.files) == sorted(j.files)
    for k in t.files:
        assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k]), k
    assert np.array_equal(np.load(tsub / "fiducials.npy"), np.load(jsub / "fiducials.npy"))


def test_convert_register_evaluate_loop(converted, tmp_path):
    _, data_root, subject, (gt, gt_rot, gt_xyz, mapper) = converted
    npz = np.load(subject / "xrays" / "000.npz")
    assert np.allclose(mapper @ np.asarray(npz["pose"])[0], gt[0], atol=1e-5)
    # the reference converter's ordering: x0 = row origin, y0 = col origin
    assert float(npz["intrinsics_x0"]) == pytest.approx(Y0, abs=1e-4)
    assert float(npz["intrinsics_y0"]) == pytest.approx(X0, abs=1e-4)

    init_rot = gt_rot + np.deg2rad([0.8, -0.6, 0.5])
    init_xyz = gt_xyz + np.array([2.0, -2.5, 1.5])
    results = tmp_path / "results" / "deepfluoro" / "subject01"
    assert port_main([
        "register", "fixed", str(subject / "xrays" / "000.dcm"),
        "-v", str(subject / "volume.nii.gz"), "-o", str(results),
        "--rot", *[f"{v:.8f}" for v in init_rot], "--xyz", *[f"{v:.8f}" for v in init_xyz],
        "--scales", "4,2,1", "--n_itrs", "100,100,80", "--lr_rot", "5e-3", "--lr_xyz", "0.5",
        "--restart_seeds", "1", "--max_restarts", "0", "--verbose", "0", "--device", "cpu",
    ]) == 0
    assert (results / "000" / "parameters.npz").exists()

    ev = _load(REPO / "scripts" / "torch" / "evaluate.py", "torch_evaluate_loop")
    out_csv = tmp_path / "scores.csv"
    assert ev.main(["-f", str(tmp_path / "results"), "-s", str(out_csv), "-d", str(data_root),
                    "--device", "cpu"]) == 0
    header, line = out_csv.read_text().strip().splitlines()
    row = dict(zip(header.split(","), line.split(",")))
    assert row["dataset"] == "deepfluoro" and row["subject"] == "subject01"
    mtre_init, mtre = float(row["mtre_init"]), float(row["mtre"])
    print(f"loop mTRE: init {mtre_init:.2f} mm -> final {mtre:.3f} mm")
    assert mtre_init > 1.5, f"perturbation too small to be a real test: {mtre_init}"
    assert mtre < 1.0, f"registration did not reach sub-mm: {mtre} (init {mtre_init})"
    assert mtre < mtre_init / 3


def test_validate_convention_matches_jax(converted, capsys):
    """The twin renders, transforms and scores the stored pose as the JAX
    script does; it passes, and a transposed rotation block fails with
    exit 1."""
    jsub, data_root, subject, _ = converted
    jvc = _load(REPO / "scripts" / "validate_convention.py", "jax_validate_convention")
    tvc = _load(REPO / "scripts" / "torch" / "validate_convention.py", "torch_validate_convention")
    j_gt, _ = jvc._load_evaluate().read_true("deepfluoro", "subject01", "000", jsub.parents[1])
    t_gt, _ = tvc._load_evaluate().read_true("deepfluoro", "subject01", "000", data_root,
                                             device="cpu")
    args = (None, jsub / "xrays" / "000.dcm")
    ref = jvc.validate_xray(jsub / "volume.nii.gz", *args, j_gt, 0, False, 128)
    got = tvc.validate_xray(jsub / "volume.nii.gz", *args, t_gt, 0, False, 128, device="cpu")
    assert got["render_hw"] == tuple(ref["render_hw"])
    assert abs(got["gncc"] - ref["gncc"]) <= NCC_ATOL
    assert abs(got["mncc"] - ref["mncc"]) <= MNCC_ATOL
    assert min(got["mncc"], ref["mncc"]) > 0.85
    # what both score: the DRR of the stored pose and the transformed X-ray
    img, sdd, delx, dely, x0, y0, _ = read_xray(args[1], crop=0, linearize=False)
    kw = dict(height=img.shape[-2], width=img.shape[-1], sdd=sdd, delx=delx, dely=dely, x0=-x0,
              y0=y0, reverse_x_axis=False, renderer="trilinear")
    scale = img.shape[-2] / 128
    drr = initialize_drr(jsub / "volume.nii.gz", None, None, "AP", **kw, device="cpu")
    j_drr = j_initialize_drr(jsub / "volume.nii.gz", None, None, "AP", **kw)
    with torch.no_grad():
        pred = drr.rescale_detector(scale)(t_gt)
    j_pred = j_drr.rescale_detector(scale)(j_gt)
    close = lambda a, b: float((a - b).abs().max()) <= NCC_ATOL * float(b.abs().max())  # noqa: E731
    assert close(pred, torch.as_tensor(np.asarray(j_pred)))
    j_img = j_read_xray(args[1], crop=0, linearize=False)[0]
    assert np.array_equal(img, np.asarray(j_img))
    assert close(make_xray_transforms(128, 128)(pred),
                 torch.as_tensor(np.asarray(j_transforms(128, 128)(j_pred))))

    argv = [str(data_root), "deepfluoro", "-n", "1", "--size", "128", "--no-linearize",
            "--device", "cpu"]
    assert tvc.main(argv) == 0
    assert "Convention check passed" in capsys.readouterr().out
    npz_path = subject / "xrays" / "000.npz"
    d = dict(np.load(npz_path))
    bad = np.asarray(d["pose"], np.float32).copy()
    bad[..., :3, :3] = np.swapaxes(bad[..., :3, :3], -1, -2)
    np.savez(npz_path, **{**d, "pose": bad})
    try:
        assert tvc.main(argv) == 1
        assert "CONVENTION CHECK FAILED" in capsys.readouterr().out
    finally:
        np.savez(npz_path, **d)


def test_validate_convention_mncc_matches_jax_without_flat_patches(converted, tmp_path):
    """The same comparison on a tree with no flat patch in either image: the
    fixture's CT with its air filled by graded soft tissue (as
    tests/test_torch_registrar.py's phantom is; its box covers the whole
    detector), and an X-ray of that CT rendered by the port at the stored
    pose in the converted DICOM's geometry. There mNCC, and gNCC, agree with
    the JAX script's within NCC_ATOL."""
    jsub, data_root, subject, _ = converted
    jvc = _load(REPO / "scripts" / "validate_convention.py", "jax_validate_convention")
    tvc = _load(REPO / "scripts" / "torch" / "validate_convention.py", "torch_validate_convention")
    data, affine = load_nifti(subject / "volume.nii.gz")
    n = data.shape[0]
    X, _, Z = np.meshgrid(*([np.arange(n, dtype=np.float32)] * 3), indexing="ij")
    vol = tmp_path / "volume.nii.gz"
    save_nifti(vol, np.where(data < -500.0, 20.0 + 150.0 * X / n + 60.0 * Z / n, data)
               .astype(np.float32), affine)
    j_gt, _ = jvc._load_evaluate().read_true("deepfluoro", "subject01", "000", jsub.parents[1])
    t_gt, _ = tvc._load_evaluate().read_true("deepfluoro", "subject01", "000", data_root,
                                             device="cpu")
    img, sdd, delx, dely, x0, y0, _ = read_xray(subject / "xrays" / "000.dcm", crop=0,
                                                linearize=False)
    drr = initialize_drr(vol, None, None, "AP", height=img.shape[-2], width=img.shape[-1], sdd=sdd,
                         delx=delx, dely=dely, x0=-x0, y0=y0, reverse_x_axis=False,
                         renderer="trilinear", device="cpu")
    with torch.no_grad():
        pixels = drr(t_gt)[0, 0].double().numpy()
    assert pixels.min() > 0.05 * pixels.max()  # every ray crosses the filled box
    xray = tmp_path / "000.dcm"
    dcmwrite(xray, np.rint(pixels / pixels.max() * 60000.0).astype(np.uint16), sdd=sdd,
             row_spacing=dely, col_spacing=delx, row_origin=y0, col_origin=x0)
    ref = jvc.validate_xray(vol, None, xray, j_gt, 0, False, 128)
    got = tvc.validate_xray(vol, None, xray, t_gt, 0, False, 128, device="cpu")
    print(f"mNCC port {got['mncc']:.6f} JAX {ref['mncc']:.6f}; gNCC port {got['gncc']:.6f} "
          f"JAX {ref['gncc']:.6f}")
    assert got["render_hw"] == tuple(ref["render_hw"])
    assert abs(got["mncc"] - ref["mncc"]) <= NCC_ATOL
    assert abs(got["gncc"] - ref["gncc"]) <= NCC_ATOL
    assert min(got["mncc"], ref["mncc"]) > 0.9
