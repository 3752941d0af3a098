"""Where phase 8's registration ends, JAX against the port (CPU).

``chip_smoke.py``'s phase 8 registers two X-rays of the whole CT (the femur
boxes, labels 5 and 6, in view) with ``--labels 1,2,3,4,7``, and ends off
its ground truth. This test registers the same subject, at 64^3 and 356^2,
with ``deepfluoro/register/finetuned.sh``'s flags (crop 100, linearize, the
mask and its labels, scales 24,12,6) through shear-warp, from the synthetic
checkpoint's offset (0.4, -0.3, 0.3) degrees and (1.5, -2.0, 1.0) mm, once
with the JAX package's ``RegistrarFixed`` and once with the port's (one
start, no re-anneal, 100 iterations per stage: the cut). It holds that

- the two packages' fine-stage similarities agree at the same poses (the
  ground truth and both final poses) within OBJECTIVE_ATOL;
- the port's final pose scores no lower than JAX's, less OBJECTIVE_ATOL;
- both end off the ground truth by a rotation of the same size and
  direction: the rotation between the two final poses is under
  ROTATION_SHARE of either one's rotation from the ground truth.

So where the port ends is where the JAX registrar ends on the same scene.
Run it alone with ``-s`` to print the numbers: mTRE, the evaluator's mTRE,
the rotation and source shift from the ground truth, and each package's
similarity at the ground truth and at both final poses.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np

import jax.numpy as jnp

from torch_threads import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
OBJECTIVE_ATOL = 1e-4  # the two packages' similarity at the same pose
ROTATION_SHARE = 0.5  # rotation between the finals / each final's rotation from GT
INIT_OFFSET = (np.deg2rad([0.4, -0.3, 0.3]), np.array([1.5, -2.0, 1.0]))
KWARGS = dict(labels="1,2,3,4,7", crop=100, linearize=True, scales="24,12,6", n_itrs="100,100,100",
              restart_seeds=1, max_restarts=0, reverse_x_axis=False, verbose=0)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_scene", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke_scene"] = mod
    spec.loader.exec_module(mod)
    return mod


def _jax_objective(reg, xray, poses):
    """The JAX registrar's fine-stage similarity at each of ``poses``, as
    its stage scores a render (chip_smoke.objective_at is the port's)."""
    from xvr_tpu.geometry import RigidTransform
    from xvr_tpu.metrics import gradient_ncc, multiscale_ncc
    from xvr_tpu.registrar.base import _parse_scales

    gt_img = reg.initialize_pose(str(xray))[0]
    scale = _parse_scales(reg.scales, reg.crop, gt_img.shape[-2])[-1]
    proj = reg.projector.rescale_detector(scale)
    _, transform = reg._make_stage(proj, 1, 9, 11, 0.0, 0.5)
    x = transform(gt_img)
    out = []
    for m in poses:
        y = transform(proj(RigidTransform(jnp.asarray(m, jnp.float32).reshape(1, 4, 4))))
        out.append(float((0.5 * multiscale_ncc(x, y, (None, 9), (0.5, 0.5))
                          + 0.5 * gradient_ncc(x, y, 11, 0.0))[0]))
    return out


def test_the_port_ends_where_jax_ends(tmp_path, monkeypatch):
    from xvr_tpu.registrar import RegistrarFixed as JaxFixed
    from xvr_tpu_torch.registrar import RegistrarFixed as PortFixed

    smoke = _smoke()
    monkeypatch.setenv("XVR_FORCE_SHEARWARP", "1")  # the card's renderer, in both packages
    hu, aff, fids = smoke.build_phantom(64)
    gt = smoke.write_deepfluoro_subject(tmp_path, "subject01", hu, aff, fids, dev="cpu", det=356)[0]
    sub = tmp_path / "data" / "deepfluoro" / "subject01"
    xray = sub / "xrays" / "000.dcm"
    (rot_deg, xyz), = smoke.WORKFLOW_POSES[:1]
    rot = (np.deg2rad(rot_deg) + INIT_OFFSET[0]).tolist()
    xyz = (np.asarray(xyz) + INIT_OFFSET[1]).tolist()
    regs, final = {}, {}
    for name, cls, extra in (("port", PortFixed, dict(device="cpu")), ("jax", JaxFixed, {})):
        regs[name] = cls(str(sub / "volume.nii.gz"), str(sub / "mask.nii.gz"), "AP", rot, xyz,
                         **KWARGS, **extra)
        pose = regs[name].run(str(xray))[4].matrix
        final[name] = np.asarray(pose.cpu() if name == "port" else pose, np.float64).reshape(4, 4)
        assert regs[name].projector.renderer == "trilinear_fast"
    poses = (gt, final["port"], final["jax"])
    obj = {"port": smoke.objective_at(regs["port"], xray, poses),
           "jax": _jax_objective(regs["jax"], xray, poses)}
    err = {name: smoke.pose_error(final[name], gt) for name in final}
    between = smoke.pose_error(final["jax"], final["port"])
    for name in final:
        print(f"{name}: final mTRE {smoke.fiducial_mtre(final[name], gt, fids):.4f} mm, the "
              f"evaluator's {smoke.evaluator_mtre(final[name], gt, fids):.4f} mm, off GT by "
              f"{err[name]}; objective at GT, port's final, JAX's final {obj[name]}")
    print(f"JAX's final against the port's: {between}, mTRE "
          f"{smoke.fiducial_mtre(final['jax'], final['port'], fids):.4f} mm")
    np.testing.assert_allclose(obj["port"], obj["jax"], rtol=0, atol=OBJECTIVE_ATOL)
    assert obj["port"][1] >= obj["jax"][2] - OBJECTIVE_ATOL
    assert between["rot_deg"] < ROTATION_SHARE * min(e["rot_deg"] for e in err.values())
