"""The port's volume, golden renderer, layout helpers, projector and state
hand-over against the JAX package (CPU).

The golden trilinear renderer is plain float32 arithmetic on both sides, so
it agrees to rtol 1e-4 of the image maximum (summation order); its gradient
comes from PyTorch's autograd and is compared with jax.grad at rtol 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvr_tpu.geometry import convert as jconvert
from xvr_tpu.render import Projector as JProjector
from xvr_tpu.render import Volume as JVolume
from xvr_tpu.render import pallas as jpallas
from xvr_tpu.render import transform_hu_to_density as j_hu
from xvr_tpu.render import xla as jxla
from xvr_tpu_torch.geometry import convert
from xvr_tpu_torch.render import Projector, Volume, raymarch_trilinear, transform_hu_to_density
from xvr_tpu_torch.render import layout
from xvr_tpu_torch.state import from_numpy_state
from torch_threads import two_torch_threads  # noqa: F401

N, H = 24, 20


@pytest.fixture(scope="module")
def ct():
    rng = np.random.default_rng(0)
    c = (N - 1) / 2
    X, Y, Z = np.meshgrid(*([np.arange(N)] * 3), indexing="ij")
    r2 = (X - c) ** 2 + (Y - c) ** 2 + (Z - c) ** 2
    hu = np.where(r2 <= (N / 2.5) ** 2, 30.0 + 4.0 * X, -1000.0).astype(np.float32)
    hu[6:10, 8:14, 5:9] = 1200.0
    hu += rng.normal(0, 5, hu.shape).astype(np.float32)
    aff = np.diag([3.0, 2.5, 2.0, 1.0]).astype(np.float32)
    aff[:3, 3] = [-30.0, -28.0, -20.0]
    return hu, aff


def _pose(rot, xyz, torch_side):
    r, t = np.asarray(rot, np.float32), np.asarray(xyz, np.float32)
    if torch_side:
        return convert(torch.as_tensor(r), torch.as_tensor(t), "euler_angles", "ZXY", degrees=True)
    return jconvert(jnp.asarray(r), jnp.asarray(t), "euler_angles", "ZXY", degrees=True)


ROT = [[178.0, 3.0, -4.0], [183.0, -2.0, 1.0]]
XYZ = [[2.0, 400.0, -3.0], [-4.0, 380.0, 5.0]]


def test_hu_transfer_matches_jax(ct):
    hu, _ = ct
    for mult in (1.0, 2.5):
        np.testing.assert_allclose(transform_hu_to_density(torch.as_tensor(hu), mult).numpy(),
                                   np.asarray(j_hu(jnp.asarray(hu), mult)), rtol=1e-6, atol=1e-7)


def test_volume_geometry_matches_jax(ct):
    hu, aff = ct
    tv = Volume(torch.as_tensor(hu), torch.as_tensor(aff))
    jv = JVolume(jnp.asarray(hu), jnp.asarray(aff))
    np.testing.assert_allclose(tv.affine_inverse.numpy(), np.asarray(jv.affine_inverse), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tv.center.numpy(), np.asarray(jv.center), rtol=1e-6)
    np.testing.assert_allclose(tv.spacing.numpy(), np.asarray(jv.spacing), rtol=1e-6)
    np.testing.assert_allclose(tv.center_translation().matrix.numpy(),
                               np.asarray(jv.center_translation().matrix), rtol=1e-6)
    pts = np.random.default_rng(2).normal(0, 20, (7, 3)).astype(np.float32)
    np.testing.assert_allclose(tv.world_to_voxel(torch.as_tensor(pts)).numpy(),
                               np.asarray(jv.world_to_voxel(jnp.asarray(pts))), rtol=1e-5, atol=1e-5)


def test_golden_renderer_and_gradient_match_jax(ct):
    hu, aff = ct
    dens = np.asarray(j_hu(jnp.asarray(hu)))
    affinv = np.linalg.inv(aff).astype(np.float32)
    jp = JProjector.from_volume(JVolume(jnp.asarray(hu), jnp.asarray(aff)), sdd=700.0, height=H, delx=2.0)
    tp = Projector.from_volume(Volume(torch.as_tensor(hu), torch.as_tensor(aff)), sdd=700.0, height=H, delx=2.0)
    assert tp.n_samples == jp.n_samples
    js, jt = jp.rays(_pose(ROT, XYZ, False))
    ts, tt = tp.rays(_pose(ROT, XYZ, True))
    ref = np.asarray(jxla.raymarch_trilinear(jnp.asarray(dens), jnp.asarray(affinv), js, jt, n_samples=64))
    got = raymarch_trilinear(torch.as_tensor(dens), torch.as_tensor(affinv), ts, tt, n_samples=64)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    # ray chunking changes nothing
    chunked = raymarch_trilinear(torch.as_tensor(dens), torch.as_tensor(affinv), ts, tt,
                                 n_samples=64, ray_chunk=37)
    np.testing.assert_allclose(chunked.numpy(), got.numpy(), rtol=1e-6, atol=1e-6)

    w = np.random.default_rng(1).normal(0, 1, ref.shape).astype(np.float32)
    jg = jax.grad(lambda t: jnp.sum(jxla.raymarch_trilinear(
        jnp.asarray(dens), jnp.asarray(affinv), js, t, n_samples=64) * w))(jt)
    tgt = tt.detach().clone().requires_grad_(True)
    (raymarch_trilinear(torch.as_tensor(dens), torch.as_tensor(affinv), ts, tgt, n_samples=64)
     * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(tgt.grad.numpy(), np.asarray(jg), rtol=1e-3,
                               atol=1e-3 * np.abs(np.asarray(jg)).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_layout_helpers_match_jax(ct, seed):
    _, aff = ct
    affinv = np.linalg.inv(aff).astype(np.float32)
    rng = np.random.default_rng(seed)
    R = np.asarray(jconvert(jnp.asarray(rng.uniform(-3, 3, (1, 3)).astype(np.float32)), None,
                            "euler_angles", "ZXY").matrix)[0, :3, :3]
    assert layout.choose_permutation_for_pose(R, affinv) == jpallas.choose_permutation_for_pose(R, affinv)
    d = rng.normal(0, 1, 3)
    assert layout._choose_permutation(d) == jpallas._choose_permutation(d)
    jp = JProjector.from_volume(JVolume(jnp.asarray(ct[0]), jnp.asarray(aff)), sdd=700.0, height=H, delx=2.0)
    src, tgt = jp.rays_host(_pose(ROT, XYZ, False))
    perm = layout.choose_permutation_for_pose(R, affinv)
    assert layout.measured_steepness(src, tgt, affinv, perm) == pytest.approx(
        jpallas.measured_steepness(src, tgt, affinv, perm), rel=1e-6)


def test_projector_shearwarp_selection_matches_jax(ct):
    """with_shearwarp picks the same permutation and renderer and keeps the
    golden renderer for steep rays (steepness > 2.8) as the JAX package
    does; the slab renderer renders the JAX package's image."""
    hu, aff = ct
    jp = JProjector.from_volume(JVolume(jnp.asarray(hu), jnp.asarray(aff)), sdd=700.0, height=H, delx=2.0)
    tp = Projector.from_volume(Volume(torch.as_tensor(hu), torch.as_tensor(aff)), sdd=700.0, height=H, delx=2.0)
    for flavor_proj_t, flavor_proj_j in ((tp, jp), (tp.replace(renderer="siddon"), jp.replace(renderer="siddon"))):
        js = flavor_proj_j.with_shearwarp(_pose(ROT[:1], XYZ[:1], False))
        ts = flavor_proj_t.with_shearwarp(_pose(ROT[:1], XYZ[:1], True))
        assert (ts.renderer, ts.pallas_perm) == (js.renderer, js.pallas_perm)
    # a 6 m wide detector at 700 mm: edge rays ~77 deg off the beam axis
    wide = dict(delx=300.0, dely=300.0)
    steep_t = tp.set_intrinsics(**wide).with_shearwarp(_pose(ROT[:1], XYZ[:1], True))
    steep_j = jp.set_intrinsics(**wide).with_shearwarp(_pose(ROT[:1], XYZ[:1], False))
    assert steep_t.renderer == steep_j.renderer == "trilinear"
    # the slab renderer (K5 on its plain version) renders the JAX package's
    # image; a window of the whole volume never clips on the JAX side
    slab_t = tp.replace(renderer="trilinear_pallas")(_pose(ROT, XYZ, True))
    slab_j = jp.replace(renderer="trilinear_pallas", pallas_window=max(hu.shape))(
        _pose(ROT, XYZ, False))
    np.testing.assert_allclose(slab_t.numpy(), np.asarray(slab_j), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(slab_j)).max())


def test_from_numpy_state_renders_like_jax(ct):
    """A JAX projector's fields, handed over as NumPy arrays and plain
    values, give a port projector that renders the same image."""
    hu, aff = ct
    jp = JProjector.from_volume(JVolume(jnp.asarray(hu), jnp.asarray(aff)), sdd=700.0, height=H,
                                delx=2.0, reverse_x_axis=True, x0=1.0, y0=-2.0)
    jpose = _pose(ROT, XYZ, False)
    jp = jp.with_shearwarp(jpose)
    proj, vol, pose = from_numpy_state(
        np.asarray(jp.volume.data), np.asarray(jp.volume.affine),
        detector=dataclasses.asdict(jp.detector), orientation=jp.volume.orientation,
        density=np.asarray(jp.density), renderer=jp.renderer, n_samples=jp.n_samples,
        pallas_perm=jp.pallas_perm, pose=np.asarray(jpose.matrix), device="cpu",
    )
    assert proj.renderer == jp.renderer == "trilinear_fast"
    assert dataclasses.asdict(proj.detector) == dataclasses.asdict(jp.detector)
    grid = (128, 128)
    ref = np.asarray(jp.replace(shearwarp_window=grid[0])(jpose))
    got = proj(pose).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-3 * np.abs(ref).max())
    gold_j = np.asarray(jp.replace(renderer="trilinear")(jpose))
    gold_t = proj.replace(renderer="trilinear")(pose).detach().numpy()
    np.testing.assert_allclose(gold_t, gold_j, rtol=1e-4, atol=1e-4 * np.abs(gold_j).max())
    assert vol.shape == hu.shape
