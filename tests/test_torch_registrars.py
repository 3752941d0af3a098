"""Parity of the port's model, DICOM and restart registrars, the inference
helpers, the ITK transforms, ``Registration`` and ``Evaluator`` with the JAX
package (CPU).

The scene is the phantom of tests/test_torch_registrar.py. Its CNN is a
ResNet-18 checkpoint written by ``chip_smoke.synthetic_checkpoint`` (random
seeded backbone, heads set a few mm off the ground truth), which both
packages load. Tolerances: poses and images from the same float32 arithmetic
to 1e-5 of their largest entry; CNN outputs to 1e-4 (tests/test_torch_models.py);
renders to 1e-4 of the image maximum (tests/test_torch_render.py); the
registration's final double geodesic to that file's 0.5 mm.
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_registrar import KW, SDD, SINGLE, build_phantom

from xvr_tpu.geometry import RigidTransform as JRigidTransform
from xvr_tpu.geometry import convert as jconvert
from xvr_tpu.io import dcmwrite as j_dcmwrite
from xvr_tpu.io import save_nifti
from xvr_tpu.io.volumes import read as jread
from xvr_tpu.metrics import Evaluator as JEvaluator
from xvr_tpu.metrics import double_geodesic as j_double_geodesic
from xvr_tpu.models import inference as jinf
from xvr_tpu.registrar import Registration as JRegistration
from xvr_tpu.registrar import RegistrarDicom as JRegistrarDicom
from xvr_tpu.registrar import RegistrarModel as JRegistrarModel
from xvr_tpu.registrar import RegistrarRestart as JRegistrarRestart
from xvr_tpu.render import Projector as JProjector
from xvr_tpu.utils import itk as jitk
from xvr_tpu_torch.geometry import RigidTransform, convert
from xvr_tpu_torch.io import dcmread, pixel_array, read
from xvr_tpu_torch.metrics import Evaluator, double_geodesic
from xvr_tpu_torch.models import inference
from xvr_tpu_torch.registrar import (
    Registration,
    RegistrarDicom,
    RegistrarModel,
    RegistrarRestart,
)
from xvr_tpu_torch.render import Projector
from xvr_tpu_torch.utils import itk
from torch_threads import two_torch_threads  # noqa: F401

MODEL_CONFIG = dict(model_name="resnet18", norm_layer="groupnorm",
                    parameterization="quaternion_adjugate", convention="ZXY",
                    unit_conversion_factor=1000.0, height=32, delx=6.0, sdd=SDD, orientation="AP")


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_entry", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, ref, rtol=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The phantom, its X-ray, the same X-ray with positioner tags, an ITK
    warp and the CNN checkpoint."""
    d, gt_mat, rot_init, xyz_init = build_phantom(tmp_path_factory.mktemp("regs"))
    ds = dcmread(d / "xray.dcm")
    j_dcmwrite(d / "positioner.dcm", pixel_array(ds), sdd=SDD, row_spacing=3.0, col_spacing=3.0,
               extra=[(0x0018, 0x1510, b"DS", "181.5"), (0x0018, 0x1511, b"DS", "-3.5"),
                      (0x0018, 0x1111, b"DS", "225")])
    (d / "warp.txt").write_text(
        "#Insight Transform File V1.0\n#Transform 0\nTransform: AffineTransform_double_3_3\n"
        "Parameters: 0.9998 -0.0175 0.0052 0.0174 0.9997 0.0157 -0.0055 -0.0156 0.9999 "
        "1.5 -2.0 0.5\nFixedParameters: 3 -2 4\n")
    gt = RigidTransform(torch.tensor(gt_mat, dtype=torch.float32))
    _chip_smoke().synthetic_checkpoint(d / "cnn.ckpt", gt, d / "xray.dcm", config=MODEL_CONFIG,
                                       device="cpu")
    return d, gt_mat


def test_resample_matches_jax():
    img = np.random.default_rng(0).uniform(size=(2, 1, 40, 48)).astype(np.float32)
    args = (1020.0, 0.31, 1.5, -2.0, 900.0, 0.35, 0.5, 1.0)
    _close(inference.resample(torch.from_numpy(img), *args), jinf.resample(jnp.asarray(img), *args))


def test_predict_pose_matches_jax(scene):
    d, _ = scene
    from xvr_tpu.io import read_xray as j_read_xray
    from xvr_tpu.models import load_model as j_load_model
    from xvr_tpu_torch.io import read_xray
    from xvr_tpu_torch.models import load_model

    xray = j_read_xray(d / "xray.dcm", 0, False, False)
    jmodel, jparams, config = j_load_model(d / "cnn.ckpt")
    jpose, jx = jinf.predict_pose(jmodel, jparams, config, *xray[:6])
    model, params, _ = load_model(d / "cnn.ckpt", device="cpu")
    pose, x = inference.predict_pose(model, params, config, *read_xray(d / "xray.dcm", 0, False,
                                                                        False)[:6])
    _close(x, jx)
    _close(pose.matrix, jpose.matrix, 1e-4)


@pytest.mark.parametrize("invert", [False, True])
def test_get_4x4_and_correct_pose_match_jax(tmp_path, scene, invert):
    """A rotating ITK warp about a fixed centre, on a volume whose affine
    flips and permutes axes (the canonical reorientation and the LPS/RAS
    conjugation both act)."""
    d, _ = scene
    aff = np.array([[0.0, -2.0, 0.0, 30.0], [1.5, 0.0, 0.0, -20.0],
                    [0.0, 0.0, -3.0, 40.0], [0.0, 0.0, 0.0, 1.0]])
    save_nifti(tmp_path / "ct.nii.gz", np.zeros((6, 8, 5), np.float32), aff)
    T = itk.get_4x4(d / "warp.txt", tmp_path / "ct.nii.gz", invert, device="cpu")
    jT = jitk.get_4x4(d / "warp.txt", tmp_path / "ct.nii.gz", invert)
    _close(T.matrix, jT.matrix)
    rot, xyz = np.array([[3.1, 0.05, -0.02]]), np.array([[3.0, 250.0, -4.0]])
    pose = convert(torch.tensor(rot, dtype=torch.float32), torch.tensor(xyz, dtype=torch.float32),
                   "euler_angles", "ZXY")
    jpose = jconvert(jnp.asarray(rot), jnp.asarray(xyz), "euler_angles", "ZXY")
    assert inference.correct_pose(pose, None, tmp_path / "ct.nii.gz", invert) is pose
    _close(inference.correct_pose(pose, d / "warp.txt", tmp_path / "ct.nii.gz", invert).matrix,
           jinf.correct_pose(jpose, d / "warp.txt", tmp_path / "ct.nii.gz", invert).matrix)


def test_read_itk_transform_matches_jax(tmp_path, scene):
    d, _ = scene
    doubles = np.arange(1.0, 16.0) / 7.0
    (tmp_path / "warp.mat").write_bytes(b"\x01\x00\x00\x00binary header" + doubles.tobytes())
    for path in (d / "warp.txt", tmp_path / "warp.mat"):
        for a, b in zip(itk.read_itk_transform(path), jitk.read_itk_transform(path)):
            np.testing.assert_array_equal(a, b)
    (tmp_path / "empty.txt").write_text("#Insight Transform File V1.0\n")
    with pytest.raises(ValueError, match="No Parameters"):
        itk.read_itk_transform(tmp_path / "empty.txt")


def test_construct_antipode_matches_jax():
    rot = np.deg2rad([[170.0, -8.0, 5.0], [10.0, 3.0, -2.0]])
    xyz = np.array([[4.0, 300.0, -6.0], [0.0, 700.0, 2.0]])
    pose = convert(torch.tensor(rot, dtype=torch.float32), torch.tensor(xyz, dtype=torch.float32),
                   "euler_angles", "ZXY")
    jpose = jconvert(jnp.asarray(rot), jnp.asarray(xyz), "euler_angles", "ZXY")
    anti = inference.construct_antipode(pose)
    _close(anti.matrix, jinf.construct_antipode(jpose).matrix)
    _close(inference.construct_antipode(anti).matrix, pose.matrix)


def _init(reg, d, name="xray.dcm", **kw):
    return reg.initialize_pose(d / name, **kw)


def test_registrar_init_poses_match_jax(scene):
    """Model (with an ITK warp and the antipode), DICOM (both orientations)
    and restart registrars start from the JAX package's poses."""
    d, gt_mat = scene
    common = dict(volume=d / "ct.nii.gz", mask=None, linearize=False, reverse_x_axis=False)
    jreg = JRegistrarModel(ckptpath=d / "cnn.ckpt", warp=d / "warp.txt", antipodal=True, **common)
    treg = RegistrarModel(ckptpath=d / "cnn.ckpt", warp=d / "warp.txt", antipodal=True,
                          device="cpu", **common)
    j, t = _init(jreg, d, return_resampled=True), _init(treg, d, return_resampled=True)
    _close(t[7].matrix, j[7].matrix, 1e-4)
    _close(t[8], j[8])
    assert treg.save_kwargs == jreg.save_kwargs
    for orientation in ("AP", "PA"):
        j = _init(JRegistrarDicom(orientation=orientation, **common), d, "positioner.dcm")
        t = _init(RegistrarDicom(orientation=orientation, device="cpu", **common), d,
                  "positioner.dcm")
        _close(t[7].matrix, j[7].matrix)
        _close(t[0], j[0])
    jt = _init(JRegistrarRestart(orientation="AP", init_pose=JRigidTransform(jnp.asarray(gt_mat)),
                                 **common), d)
    tt = _init(RegistrarRestart(orientation="AP", init_pose=RigidTransform(torch.tensor(gt_mat)),
                                device="cpu", **common), d)
    np.testing.assert_array_equal(tt[7].matrix.numpy(), np.asarray(jt[7].matrix))


def test_registration_and_evaluator_match_jax(scene):
    d, gt_mat = scene
    kw = dict(sdd=SDD, height=32, delx=6.0)
    proj = Projector.from_volume(read(d / "ct.nii.gz", device="cpu"), **kw)
    jproj = JProjector.from_volume(jread(d / "ct.nii.gz"), **kw)
    rot, xyz = np.deg2rad([[182.0, -1.0, 3.5]]), np.array([[4.0, 215.0, -1.0]])
    reg = Registration(proj, torch.tensor(rot, dtype=torch.float32),
                       torch.tensor(xyz, dtype=torch.float32))
    jreg = JRegistration(jproj, jnp.asarray(rot), jnp.asarray(xyz))
    _close(reg.pose.matrix, jreg.pose.matrix)
    with torch.no_grad():
        _close(reg(), jreg(), 1e-4)
    fids = np.random.default_rng(3).uniform(-30.0, 30.0, (1, 12, 3))
    true = RigidTransform(torch.tensor(gt_mat, dtype=torch.float32))
    got = Evaluator(proj, fids)(true, reg.pose).numpy()
    ref = np.asarray(JEvaluator(jproj, jnp.asarray(fids))(JRigidTransform(jnp.asarray(gt_mat)),
                                                           jreg.pose))
    assert got.shape == ref.shape == (4,) and (ref > 0.5).all()
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_register_model_run_matches_jax(scene, tmp_path):
    """One RegistrarModel run from the CNN's own init, through shear-warp on
    both sides (XVR_FORCE_SHEARWARP): the final double geodesic to the
    ground truth is within 0.5 mm of the JAX package's and better than the
    init's; the bundle has the JAX keys."""
    d, gt_mat = scene
    kw = dict(volume=d / "ct.nii.gz", mask=None, ckptpath=d / "cnn.ckpt", **KW, **SINGLE)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XVR_FORCE_SHEARWARP", "1")
        jout = JRegistrarModel(**kw).run(d / "xray.dcm")
        treg = RegistrarModel(device="cpu", **kw)
        tout = treg.run(d / "xray.dcm")
    jd = float(np.squeeze(j_double_geodesic(JRigidTransform(jnp.asarray(gt_mat)), jout[4], SDD)[2]))
    gt = RigidTransform(torch.tensor(gt_mat, dtype=torch.float32))
    td = float(double_geodesic(gt, tout[4], SDD)[2].squeeze())
    td0 = float(double_geodesic(gt, tout[3], SDD)[2].squeeze())
    assert td < td0, (td0, td)
    assert abs(td - jd) < 0.5, (jd, td)
    path = treg._save_result(d / "xray.dcm", tmp_path, tout)
    meta = json.loads((path / "parameters.json").read_text())
    assert meta["type"] == "model" and meta["ckptpath"] == str(d / "cnn.ckpt") and meta["date"]
