"""Parity of the PyTorch shear-warp renderer with the JAX package (CPU).

Every kernel of the registration path (K1 accumulate, K2 warp, K3 warp
partials, K4 source adjoint) has a plain PyTorch version that runs on CPU
tensors. Here each one is held against the JAX package's oracles on the same
NumPy inputs: the XLA scans and the Pallas kernels in interpret mode (run as
the JAX package's own tests run them), and the whole fast render and its
pose gradient against ``xvr_tpu.render.shearwarp.raymarch_trilinear_fast``.

Tolerances come from the JAX package's own bf16 paths, not from f32
round-off: its two accumulate implementations agree to rtol 2e-2 /
atol 2e-3 * max and its two adjoints to rtol 3e-2 / atol 3e-3 * max
(tests/test_shearwarp.py). The JAX warp reads the slope image as bf16 pairs
while the port reads it in f32, so warp values agree to bf16 rounding
(relative 2^-8 of the image's range).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvr_tpu.geometry import Detector as JDetector, convert as jconvert
from xvr_tpu.render import shearwarp as jsw
from xvr_tpu.render.pallas import choose_permutation_for_pose as j_choose_perm
from xvr_tpu_torch.geometry import Detector, convert
from xvr_tpu_torch.render import shearwarp as tsw
from xvr_tpu_torch.render.layout import choose_permutation_for_pose

N = 40
H = 64


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    g = np.linspace(-1, 1, N)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    blob = np.exp(-((X * 1.2) ** 2 + (Y * 0.8) ** 2 + (Z * 1.1) ** 2) * 6.0)
    density = ((blob * 800.0 + blob * rng.normal(0.0, 40.0, blob.shape)) / 1000.0).astype(np.float32)
    spacing = 2.0
    aff = np.eye(4, dtype=np.float32) * spacing
    aff[3, 3] = 1.0
    aff[:3, 3] = -(N - 1) / 2.0 * spacing
    affinv = np.linalg.inv(aff).astype(np.float32)
    rot = np.array([[2.0, -1.5, 2.5], [0.0, 0.0, 0.0], [-2.5, 1.0, -1.5]], np.float32)
    xyz = np.array([[5.0, 600.0, -8.0], [0.0, 650.0, 0.0], [-6.0, 550.0, 4.0]], np.float32)
    perm = choose_permutation_for_pose(np.eye(3), affinv)
    assert perm == j_choose_perm(np.eye(3), affinv)
    return dict(density=density, affinv=affinv, rot=rot, xyz=xyz, perm=perm)


def _rays_both(s):
    jdet = JDetector(sdd=1020.0, height=H, width=H, delx=1.5, dely=1.5)
    tdet = Detector(sdd=1020.0, height=H, width=H, delx=1.5, dely=1.5)
    jpose = jconvert(jnp.asarray(s["rot"]), jnp.asarray(s["xyz"]), "euler_angles", "ZXY", degrees=True)
    tpose = convert(_t(s["rot"]), _t(s["xyz"]), "euler_angles", "ZXY", degrees=True)
    return jdet.rays(jpose), tdet.rays(tpose)


def _slab_inputs(seed, sgnval, B=5, M=16, Wd=10, L=20):
    rng = np.random.default_rng(seed)
    vol = rng.normal(0.5, 0.3, (M, Wd, L)).astype(np.float32)
    s_p = (rng.normal(0.0, 2.0, (B, 3)) + np.array([-8.0, 5.0, 10.0])).astype(np.float32)
    sgn = np.full((B,), sgnval, np.float32)
    u0 = rng.normal(-0.5, 0.1, B).astype(np.float32)
    du = rng.uniform(0.02, 0.08, B).astype(np.float32)
    v0 = rng.normal(-0.8, 0.1, B).astype(np.float32)
    dv = rng.uniform(0.02, 0.05, B).astype(np.float32)
    return vol, s_p, sgn, u0, du, v0, dv


def _both(args):
    vol, *rest = args
    jargs = [jnp.asarray(vol).astype(jnp.bfloat16)] + [jnp.asarray(a) for a in rest]
    targs = [_t(vol).to(torch.bfloat16)] + [_t(a) for a in rest]
    return jargs, targs


ACC_CASES = [
    (1.0, 0, None, 1.0),
    (0.25, 0, None, 1.0),
    (1.0, 4, 12, -1.0),
    (0.25, 2, 14, -1.0),
]


@pytest.mark.parametrize("eps,k0,k1,sgnval", ACC_CASES)
def test_accumulate_plain_matches_jax(eps, k0, k1, sgnval):
    """K1's plain version against the XLA scan and the Pallas kernel
    (interpret mode); tolerance of the JAX package's own two bf16 paths."""
    Iu, Iv = 16, 128
    jargs, targs = _both(_slab_inputs(3, sgnval))
    kw = dict(Iu=Iu, Iv=Iv, eps=eps, k0=k0, k1=k1)
    got = tsw.accumulate(*targs, **kw).numpy()
    for ref in (
        np.asarray(jsw._accumulate(*jargs, unroll=4, **kw)),
        np.asarray(jsw._accumulate_fused(*jargs, unroll=4, interpret=True, **kw)),
    ):
        scale = max(np.abs(ref).max(), 1e-6)
        np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-3 * scale)


@pytest.mark.parametrize("eps,k0,k1,sgnval", ACC_CASES)
def test_accumulate_adjoint_plain_matches_jax(eps, k0, k1, sgnval):
    """K4's plain version (contracted to g_s) against the XLA adjoint scan
    and the Pallas adjoint (interpret mode); the JAX adjoints' tolerance."""
    Iu, Iv = 16, 128
    args = _slab_inputs(7, sgnval)
    ibar = np.random.default_rng(8).normal(0.0, 1.0, (5, Iu, Iv)).astype(np.float32)
    jargs, targs = _both(args)
    kw = dict(Iu=Iu, Iv=Iv, eps=eps, k0=k0, k1=k1)
    got = tsw.accumulate_adjoint(*targs, _t(ibar), **kw).numpy()
    for ref in (
        np.asarray(jsw._accumulate_adjoint(*jargs, jnp.asarray(ibar), unroll=4, **kw)),
        np.asarray(jsw._accumulate_adjoint_fused(*jargs, jnp.asarray(ibar), unroll=4,
                                                 interpret=True, **kw)),
    ):
        scale = max(np.abs(ref).max(), 1e-6)
        np.testing.assert_allclose(got, ref, rtol=3e-2, atol=3e-3 * scale)


def _warp_inputs(seed, B=3, Iu=16, Iv=128, Hd=12, Wdet=20):
    rng = np.random.default_rng(seed)
    I = rng.uniform(0.0, 1.0, (B, Iu, Iv)).astype(np.float32)
    # coordinates reach past every edge so the validity mask is exercised
    uc = rng.uniform(-2.0, Iu + 1.0, (B, Hd * Wdet)).astype(np.float32)
    vc = rng.uniform(-1.5, Iv + 0.5, (B, Hd * Wdet)).astype(np.float32)
    ws = rng.uniform(-0.2, 2.0, (B, Hd * Wdet)).astype(np.float32)
    return I, uc, vc, ws, (Iu, Iv), (Hd, Wdet)


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_plain_matches_jax(seed):
    """K2's plain version against the Pallas warp (interpret mode, window =
    Iu so the JAX side clips nothing); bf16 rounding of the JAX table."""
    I, uc, vc, ws, grid, det = _warp_inputs(seed)
    ref = np.asarray(jsw._warp(
        jnp.asarray(I), jnp.asarray(uc), jnp.asarray(vc), jnp.asarray(ws),
        det_shape=det, grid_shape=grid, window=grid[0], interpret=True,
    ))
    got = tsw.warp(_t(I), _t(uc), _t(vc), _t(ws)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-2, atol=4e-3 * np.abs(ws).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_with_grads_plain_matches_jax(seed):
    """K3's plain version: value and both partials against the Pallas
    kernel (interpret mode, window = Iu)."""
    I, uc, vc, ws, grid, det = _warp_inputs(seed)
    refs = jsw._warp_with_grads(
        jnp.asarray(I), jnp.asarray(uc), jnp.asarray(vc), jnp.asarray(ws),
        det_shape=det, grid_shape=grid, window=grid[0], interpret=True,
    )
    gots = tsw.warp_with_grads(_t(I), _t(uc), _t(vc), _t(ws))
    for got, ref in zip(gots, refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-2, atol=8e-3)


def test_warp_transpose_matches_jax():
    """The bilinear scatter-add against the JAX dense hat-matrix transpose
    (bf16 hat factors on the JAX side)."""
    I, uc, vc, ws, grid, det = _warp_inputs(5)
    gw = np.random.default_rng(6).normal(0.0, 1.0, uc.shape).astype(np.float32)
    ref = np.asarray(jsw._warp_transpose(jnp.asarray(gw), jnp.asarray(uc), jnp.asarray(vc),
                                         grid_shape=grid, det_shape=det))
    got = tsw._warp_transpose(_t(gw), _t(uc), _t(vc), grid_shape=grid).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-3 * np.abs(ref).max())


@pytest.mark.parametrize("eps", [1.0, 0.25])
def test_fast_forward_matches_jax(scene, eps):
    """The whole fast render (accumulate + warp) against the JAX fast path
    with an unclipped warp window."""
    (jsrc, jtgt), (tsrc, ttgt) = _rays_both(scene)
    grid = jsw.default_grid_shape((H, H))
    assert grid == tsw.default_grid_shape((H, H))
    ref = np.asarray(jsw.raymarch_trilinear_fast(
        jnp.asarray(scene["density"]), jnp.asarray(scene["affinv"]), jsrc, jtgt,
        perm=scene["perm"], warp_window=grid[0], eps=eps,
    ))
    got = tsw.raymarch_trilinear_fast(
        _t(scene["density"]), _t(scene["affinv"]), tsrc, ttgt, perm=scene["perm"], eps=eps,
    ).detach().numpy()
    fwd_only = tsw.raymarch_trilinear_shearwarp(
        _t(scene["density"]), _t(scene["affinv"]), tsrc, ttgt, perm=scene["perm"], eps=eps,
    ).numpy()
    np.testing.assert_array_equal(fwd_only, got)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-3 * scale)


@pytest.mark.parametrize("eps", [1.0, 0.25])
@pytest.mark.parametrize("r0", [
    [2.2, -1.3, 2.7, 4.0, 610.0, -7.0],
    [1.0, -2.5, 3.5, 7.0, 590.0, -4.0],
])
def test_fast_pose_gradient_matches_jax(scene, eps, r0):
    """d(loss)/d(pose) through convert -> rays -> fast render (the analytic
    adjoint backward) against jax.grad of the same loss, the registration-
    style loss of tests/test_shearwarp.py (squared error to a golden render
    at a nearby pose): cosine > 0.999 and norms within 3%.

    The rotation components are the sensitive ones: the JAX warp reads the
    slope image as bf16, which moves them by up to ~100 (of ~5000) on this
    scene; the port reads f32 and lands nearer the golden gradient."""
    from xvr_tpu.render import xla as jxla

    jdet = JDetector(sdd=1020.0, height=H, width=H, delx=1.5, dely=1.5)
    tdet = Detector(sdd=1020.0, height=H, width=H, delx=1.5, dely=1.5)
    grid = jsw.default_grid_shape((H, H))
    dens_j, aff_j = jnp.asarray(scene["density"]), jnp.asarray(scene["affinv"])
    p_ref = jconvert(jnp.asarray(scene["rot"][:1]), jnp.asarray(scene["xyz"][:1]),
                     "euler_angles", "ZXY", degrees=True)
    ref = np.asarray(jxla.raymarch_trilinear(dens_j, aff_j, *jdet.rays(p_ref), n_samples=512))

    def jloss(r6):
        p = jconvert(r6[None, :3], r6[None, 3:], "euler_angles", "ZXY", degrees=True)
        img = jsw.raymarch_trilinear_fast(dens_j, aff_j, *jdet.rays(p), perm=scene["perm"],
                                          warp_window=grid[0], eps=eps)
        return jnp.sum((img - jnp.asarray(ref)) ** 2)

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(r0, jnp.float32)))

    r6 = torch.tensor(r0, dtype=torch.float32, requires_grad=True)
    p = convert(r6[None, :3], r6[None, 3:], "euler_angles", "ZXY", degrees=True)
    img = tsw.raymarch_trilinear_fast(_t(scene["density"]), _t(scene["affinv"]), *tdet.rays(p),
                                      perm=scene["perm"], eps=eps)
    ((img - _t(ref)) ** 2).sum().backward()
    tg = r6.grad.numpy()

    cos = float(np.dot(jg, tg) / (np.linalg.norm(jg) * np.linalg.norm(tg)))
    ratio = float(np.linalg.norm(tg) / np.linalg.norm(jg))
    assert cos > 0.999, (cos, jg, tg)
    assert abs(ratio - 1.0) < 0.03, (ratio, jg, tg)


def test_fast_slab_backward_matches_jax(scene):
    """backward="slab" (the shear-warp forward with the slab kernel's VJP,
    K6 on its plain version) against the JAX package's (its _kernel_bwd in
    interpret mode, a slab window of the whole volume): the same float32
    arithmetic on the same bf16 table, to atol 1e-4 * max."""
    (jsrc, jtgt), (tsrc, ttgt) = _rays_both(scene)
    jsrc, jtgt, tsrc, ttgt = jsrc[:1], jtgt[:1], tsrc[:1], ttgt[:1]
    w = np.random.default_rng(4).normal(size=(1, H * H)).astype(np.float32)
    dens_j, aff_j = jnp.asarray(scene["density"]), jnp.asarray(scene["affinv"])

    def jloss(t):
        img = jsw.raymarch_trilinear_fast(dens_j, aff_j, jsrc, t, perm=scene["perm"],
                                          warp_window=128, slab_window=N, backward="slab")
        return jnp.sum(img * w)

    jg = np.asarray(jax.grad(jloss)(jtgt))
    tgt = ttgt.detach().clone().requires_grad_(True)
    img = tsw.raymarch_trilinear_fast(_t(scene["density"]), _t(scene["affinv"]), tsrc, tgt,
                                      perm=scene["perm"], backward="slab")
    (img * _t(w)).sum().backward()
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(tgt.grad.numpy(), jg, rtol=1e-4, atol=1e-4 * np.abs(jg).max())


def test_unported_options_raise(scene):
    (_, _), (tsrc, ttgt) = _rays_both(scene)
    args = (_t(scene["density"]), _t(scene["affinv"]), tsrc, ttgt)
    with pytest.raises(ValueError, match="unknown backward"):
        tsw.raymarch_trilinear_fast(*args, perm=scene["perm"], backward="scan")
    with pytest.raises(NotImplementedError, match="channel"):
        tsw.raymarch_trilinear_fast(*args, perm=scene["perm"],
                                    mask=torch.ones(N, N, N, dtype=torch.int32), labels=(1,))
    with pytest.raises(NotImplementedError, match="grid_bounds"):
        tsw.raymarch_trilinear_fast(*args, perm=scene["perm"], grid_bounds=(0, 1, 0, 1, 1))
