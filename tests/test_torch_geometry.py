"""Parity of the port's pose algebra and detector with the JAX package (CPU).

Inputs are made with NumPy from a seed and fed to both packages; outputs
agree to rtol 1e-5 (both compute in float32; the atol covers entries near
zero, where a relative bound says nothing).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvr_tpu.geometry import Detector as JDetector
from xvr_tpu.geometry import RigidTransform as JRigidTransform
from xvr_tpu.geometry import convert as jconvert
from xvr_tpu.geometry import se3 as jse3
from xvr_tpu.geometry import so3 as jso3
from xvr_tpu_torch.geometry import Detector, RigidTransform, convert, se3, so3
from torch_threads import two_torch_threads  # noqa: F401

RTOL, ATOL = 1e-5, 1e-5


def close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


def _rot(seed, n=8):
    rng = np.random.default_rng(seed)
    return rng.uniform(-np.pi / 2, np.pi / 2, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("convention", ["ZXY", "XYZ", "ZYX", "YZX", "ZXZ", "XYX"])
def test_euler_roundtrip_matches_jax(convention):
    a = _rot(0)
    Rj = jso3.euler_to_matrix(jnp.asarray(a), convention)
    Rt = so3.euler_to_matrix(torch.as_tensor(a), convention)
    close(Rt, Rj)
    close(so3.matrix_to_euler(Rt, convention), jso3.matrix_to_euler(Rj, convention), atol=1e-4)
    close(so3.euler_to_matrix(torch.as_tensor(a), convention, degrees=True),
          jso3.euler_to_matrix(jnp.asarray(a), convention, degrees=True))


PARAMS = ["euler_angles", "axis_angle", "quaternion", "rotation_6d", "rotation_10d",
          "quaternion_adjugate", "matrix", "se3_log_map"]


@pytest.mark.parametrize("parameterization", PARAMS)
def test_convert_all_parameterizations_match_jax(parameterization):
    """convert() into a matrix and RigidTransform.convert() back, for every
    parameterization; the representation is compared through the matrix it
    rebuilds (eigenvector and quaternion signs are not unique)."""
    rng = np.random.default_rng(1)
    R = jso3.euler_to_matrix(jnp.asarray(_rot(2)), "ZXY")
    xyz = rng.normal(0.0, 50.0, (8, 3)).astype(np.float32)
    jpose = jconvert(R, jnp.asarray(xyz), "matrix")
    jrot, jt = jpose.convert(parameterization, "ZXY")
    tpose = convert(torch.as_tensor(np.asarray(R)), torch.as_tensor(xyz), "matrix")
    close(tpose.matrix, jpose.matrix, atol=1e-4)
    trot, tt = tpose.convert(parameterization, "ZXY")
    close(tt, jt, atol=1e-3)
    # rebuild from the JAX representation on both sides
    back_j = jconvert(jrot, jt, parameterization, "ZXY")
    back_t = convert(torch.as_tensor(np.asarray(jrot)), torch.as_tensor(np.asarray(jt)),
                     parameterization, "ZXY")
    close(back_t.matrix, back_j.matrix, atol=1e-4)
    # and the port's own representation rebuilds the same pose
    close(convert(trot, tt, parameterization, "ZXY").matrix, jpose.matrix, atol=1e-3)


def test_se3_exp_log_match_jax():
    rng = np.random.default_rng(3)
    w = rng.normal(0.0, 0.7, (16, 3)).astype(np.float32)
    w[0] = 0.0  # the small-angle branch
    w[1] = 1e-5
    v = rng.normal(0.0, 30.0, (16, 3)).astype(np.float32)
    Tj = jse3.se3_exp_map(jnp.asarray(w), jnp.asarray(v))
    Tt = se3.se3_exp_map(torch.as_tensor(w), torch.as_tensor(v))
    close(Tt.matrix, Tj.matrix, atol=1e-4)
    wj, vj = jse3.se3_log_map(Tj)
    wt, vt = se3.se3_log_map(Tt)
    close(wt, wj, atol=1e-4)
    close(vt, vj, atol=1e-3)


def test_rigid_transform_algebra_matches_jax():
    rng = np.random.default_rng(4)
    a = jconvert(jnp.asarray(_rot(5, 4)), jnp.asarray(rng.normal(0, 10, (4, 3)).astype(np.float32)),
                 "euler_angles", "ZXY")
    b = jconvert(jnp.asarray(_rot(6, 4)), jnp.asarray(rng.normal(0, 10, (4, 3)).astype(np.float32)),
                 "euler_angles", "ZXY")
    ta, tb = RigidTransform(torch.as_tensor(np.asarray(a.matrix))), RigidTransform(torch.as_tensor(np.asarray(b.matrix)))
    close(ta.compose(tb).matrix, a.compose(b).matrix, atol=1e-4)
    close(ta.inverse().matrix, a.inverse().matrix, atol=1e-4)
    pts = rng.normal(0, 20, (4, 5, 3)).astype(np.float32)
    close(ta(torch.as_tensor(pts)), a(jnp.asarray(pts)), atol=1e-3)
    close(ta.apply(torch.as_tensor(pts)), a.apply(jnp.asarray(pts)), atol=1e-3)
    close(RigidTransform.identity((2,), device="cpu").matrix, JRigidTransform.identity((2,)).matrix)
    close(se3.project_onto_SO3(ta).matrix, jse3.project_onto_SO3(a).matrix, atol=1e-4)


@pytest.mark.parametrize("reverse_x_axis", [False, True])
def test_detector_rays_match_jax(reverse_x_axis):
    kw = dict(sdd=1020.0, height=12, width=10, delx=1.5, dely=1.25, x0=2.0, y0=-3.0,
              reverse_x_axis=reverse_x_axis)
    jd, td = JDetector(**kw), Detector(**kw)
    rot = _rot(7, 3) * 0.2
    xyz = np.array([[0.0, 700.0, 0.0], [5.0, 650.0, -3.0], [-2.0, 720.0, 8.0]], np.float32)
    jp = jconvert(jnp.asarray(rot), jnp.asarray(xyz), "euler_angles", "ZXY")
    tp = convert(torch.as_tensor(rot), torch.as_tensor(xyz), "euler_angles", "ZXY")
    (js, jt), (ts, tt) = jd.rays(jp), td.rays(tp)
    close(ts, js, atol=1e-3)
    close(tt, jt, atol=1e-3)
    hs, ht = td.rays_numpy(tp.matrix.numpy())
    jhs, jht = jd.rays_numpy(np.asarray(jp.matrix))
    close(hs, jhs)
    close(ht, jht)
    pts = np.random.default_rng(8).normal(0, 30, (3, 6, 3)).astype(np.float32)
    close(td.perspective_projection(tp, torch.as_tensor(pts)),
          jd.perspective_projection(jp, jnp.asarray(pts)), atol=1e-3)
    px = np.random.default_rng(9).uniform(0, 10, (3, 6, 2)).astype(np.float32)
    close(td.inverse_projection(tp, torch.as_tensor(px)),
          jd.inverse_projection(jp, jnp.asarray(px)), atol=1e-3)
    assert td.rescale(2.5) == Detector(**{**kw, **vars(jd.rescale(2.5))})


def test_rigid_transform_is_differentiable():
    rot = torch.tensor([[0.1, -0.2, 0.3]], requires_grad=True)
    xyz = torch.tensor([[1.0, 600.0, -2.0]], requires_grad=True)
    pose = convert(rot, xyz, "euler_angles", "ZXY")
    pose.matrix.sum().backward()
    assert torch.isfinite(rot.grad).all() and torch.isfinite(xyz.grad).all()
    assert JRigidTransform  # the JAX twin is importable beside it


def test_vee_and_axis_angle_to_quaternion_match_jax():
    """vee inverts hat on both sides; axis_angle_to_quaternion takes both
    branches (theta^2 below 1e-12 and above) and agrees with JAX to RTOL."""
    rng = np.random.default_rng(10)
    w = rng.normal(0.0, 0.8, (8, 3)).astype(np.float32)
    w[0] = 0.0
    w[1] = 3e-7  # theta^2 ~ 3e-13: the series branch
    W = rng.normal(0.0, 1.0, (2, 4, 3, 3)).astype(np.float32)
    close(so3.vee(torch.as_tensor(W)), jso3.vee(jnp.asarray(W)))
    close(so3.vee(so3.hat(torch.as_tensor(w))), w)
    q = so3.axis_angle_to_quaternion(torch.as_tensor(w))
    close(q, jso3.axis_angle_to_quaternion(jnp.asarray(w)))
    close(so3.quaternion_to_matrix(q), so3.axis_angle_to_matrix(torch.as_tensor(w)))
