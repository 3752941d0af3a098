"""The plain reference against the port's CPU path at a tiny size.

The reference (``portbench/reference.py``) imports nothing of the port; here
both are imported and fed the same inputs: the port's plain shear-warp
versions with ``bf16=False`` compute the kernels' float32 arithmetic, which
the reference's ``float32`` precision follows, and their default recipe
(bf16 hat factors and partial products) is what the reference's
``bfloat16`` precision, the benchmark's control, follows.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import reference as ref
from portbench import scene


@pytest.fixture(scope="module")
def subject(tmp_path_factory):
    hu, aff, fids = scene.build_ct(32, 7, "cpu")
    mask = scene.deepfluoro_mask(hu)
    d = tmp_path_factory.mktemp("subject")
    scene.write_nifti(d / "ct.nii", hu.numpy(), aff)
    scene.write_nifti(d / "mask.nii", mask.numpy(), aff)
    return dict(dir=d, hu=hu, mask=mask, aff=aff, fids=fids)


def _views(n=3):
    return scene.draw_views(np.random.default_rng(3), n, 5.0, 15.0)


def test_pose_and_rays_match_the_port():
    from xvr_tpu_torch.geometry import convert
    from xvr_tpu_torch.geometry.detector import Detector

    rot, xyz = _views()
    mine = scene.poses(rot, xyz, "cpu")
    port = convert(torch.tensor(rot, dtype=torch.float64), torch.tensor(xyz, dtype=torch.float64),
                   "euler_angles", "ZXY").matrix.float()
    torch.testing.assert_close(mine, port, rtol=0, atol=1e-4)
    det = ref.Detector(1020.0, 40, 40, 2.0, 2.0)
    pdet = Detector(sdd=1020.0, height=40, width=40, delx=2.0, dely=2.0)
    from xvr_tpu_torch.geometry import RigidTransform

    for a, b in zip(det.rays(mine), pdet.rays(RigidTransform(mine))):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-3)
    for f in (24 * 256 / 356, 6 * 256 / 356):
        r, p = det.rescale(f), pdet.rescale(f)
        assert (r.height, r.width, r.delx, r.dely) == (p.height, p.width, p.delx, p.dely)


def test_masked_density_matches_the_port(subject):
    from xvr_tpu_torch.io.volumes import read
    from xvr_tpu_torch.render.volume import transform_hu_to_density

    vol = read(subject["dir"] / "ct.nii", subject["dir"] / "mask.nii", labels="1,2,3,4,7",
               device="cpu")
    want = transform_hu_to_density(vol.data)
    got = ref.hu_to_density(ref.kept_hu(subject["hu"], subject["mask"], (1, 2, 3, 4, 7)))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(vol.affine.double(), torch.as_tensor(subject["aff"]), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("precision,bf16", [("float32", False), ("bfloat16", True)])
def test_render_matches_the_port_plain_version(subject, precision, bf16):
    from xvr_tpu_torch.geometry import RigidTransform
    from xvr_tpu_torch.render import Projector, Volume
    from xvr_tpu_torch.render import shearwarp as sw

    density = ref.hu_to_density(subject["hu"])
    aff = torch.as_tensor(subject["aff"], dtype=torch.float32)
    pose = scene.poses(*_views(), "cpu")
    det = ref.Detector(1020.0, 48, 48, 1.6, 1.6)
    proj = Projector.from_volume(Volume(subject["hu"].float(), aff), sdd=1020.0, height=48,
                                 delx=1.6).with_shearwarp(RigidTransform(pose))
    perm = ref.permutation(pose, np.linalg.inv(subject["aff"]))
    assert perm == proj.pallas_perm
    vol = density.permute(*perm).contiguous().to(torch.bfloat16)
    src, tgt = proj.rays(RigidTransform(pose))
    s_p, d_p, ws = sw._decompose(proj.affine_inverse, src, tgt, perm)
    grid = sw.default_grid_shape((48, 48))
    sgn, _, u0, du, v0, dv, uc, vc = sw._grid(d_p, *grid)
    I = sw._accumulate(vol, s_p[:, 0, :], sgn, u0, du, v0, dv, Iu=grid[0], Iv=grid[1], bf16=bf16)
    want = sw._warp_plain(I, uc, vc, ws, bf16=bf16).reshape(-1, 48, 48)
    got = ref.render(vol, proj.affine_inverse, pose, det, perm, precision=precision)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


def test_xray_preprocessing_transform_and_similarity_match_the_port(tmp_path):
    from xvr_tpu_torch.io.xray import read_xray
    from xvr_tpu_torch.metrics.ncc import make_imagesim
    from xvr_tpu_torch.utils.transforms import make_xray_transforms

    rng = np.random.default_rng(0)
    px = rng.integers(0, 60000, (60, 60)).astype(np.uint16)
    scene.write_dicom(tmp_path / "x.dcm", px, 1020.0, 0.5)
    img, sdd, delx, dely, *_ = read_xray(tmp_path / "x.dcm", crop=10, linearize=True)
    assert (sdd, delx, dely) == (1020.0, 0.5, 0.5)
    mine = ref.preprocess_xray(px, 10, True)
    torch.testing.assert_close(mine, torch.as_tensor(img), rtol=0, atol=0)
    render = torch.as_tensor(rng.normal(size=(2, 1, 21, 21)), dtype=torch.float32)
    tf = make_xray_transforms(21)
    torch.testing.assert_close(ref.xray_transform(mine.expand(2, 1, 50, 50), 21, 21),
                               tf(torch.as_tensor(img).expand(2, 1, 50, 50)), rtol=0, atol=1e-6)
    x, y = tf(torch.as_tensor(img).expand(2, 1, 50, 50)), tf(render)
    torch.testing.assert_close(ref.similarity(x, y), make_imagesim(9, 11, 0.0, 0.5)(x, y),
                               rtol=0, atol=1e-6)


def test_mtre_is_zero_at_the_truth_and_grows_with_the_error(subject):
    rot, xyz = _views(1)
    gt = scene.poses(rot, xyz, "cpu")[0].numpy()
    assert ref.fiducial_mtre(gt, gt, subject["fids"]) == 0.0
    off = scene.poses(rot, xyz + np.array([[0.0, 0.0, 3.0]]), "cpu")[0].numpy()
    assert abs(ref.fiducial_mtre(off, gt, subject["fids"]) - 3.0) < 1e-3


def test_projection_distance_matches_the_port_detector(subject):
    from xvr_tpu_torch.geometry import RigidTransform
    from xvr_tpu_torch.geometry.detector import Detector

    rot, xyz = _views(1)
    gt = scene.poses(rot, xyz, "cpu").double()
    off = scene.poses(rot + 0.01, xyz + np.array([[2.0, 5.0, -3.0]]), "cpu").double()
    det = Detector(sdd=1020.0, height=100, width=100, delx=0.5, dely=0.5)
    pts = torch.as_tensor(subject["fids"])[None]
    a = det.perspective_projection(RigidTransform(off), pts)[0]
    b = det.perspective_projection(RigidTransform(gt), pts)[0]
    want = float(torch.linalg.norm((a - b) * 0.5, dim=-1).mean())
    got = ref.projection_distance(off[0].numpy(), gt[0].numpy(), subject["fids"], 1020.0)
    assert abs(got - want) < 1e-6 * want
