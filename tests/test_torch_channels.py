"""Label-channel shear-warp renders of the port against the JAX package (CPU).

A masked render has C = 1 + len(labels) channels: the port stacks the full
density and the per-label masked densities (``prepare_shearwarp``), marches
each label channel over its own slab range (``channel_slab_bounds``), folds
the channels into the warp batch, and emits [background, labels...]. Each
piece is held against ``xvr_tpu.render.shearwarp`` on the same NumPy inputs;
on the CPU the JAX package's accumulate and adjoint are its XLA scans.

Tolerances are those of tests/test_torch_shearwarp.py: the forward to
rtol 2e-2 / atol 2e-3 * max (the JAX package's bf16 accumulate), the pose
gradient to cosine > 0.999 with norms within 3%. The slab bounds and the
bf16 stacks are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvr_tpu.geometry import Detector as JDetector, convert as jconvert
from xvr_tpu.render import Projector as JProjector, Volume as JVolume
from xvr_tpu.render import shearwarp as jsw
from xvr_tpu.render import xla as jxla
from xvr_tpu_torch.geometry import Detector, convert
from xvr_tpu_torch.render import Projector, Volume
from xvr_tpu_torch.render import shearwarp as tsw
from xvr_tpu_torch.render.layout import choose_permutation_for_pose
from torch_threads import two_torch_threads  # noqa: F401


N = 40
H = 48
LABELS = (1, 2, 5)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.fixture(scope="module")
def scene():
    """A noisy blob with three compact, disjoint labels at different depths
    along every axis, so that each label's slab range is trimmed."""
    rng = np.random.default_rng(3)
    g = np.linspace(-1, 1, N)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    blob = np.exp(-((X * 1.2) ** 2 + (Y * 0.8) ** 2 + (Z * 1.1) ** 2) * 6.0)
    density = ((blob * 800.0 + blob * rng.normal(0.0, 40.0, blob.shape)) / 1000.0).astype(np.float32)
    mask = np.zeros((N, N, N), np.int32)
    for lab, c, r in ((1, (-0.4, -0.3, -0.35), 0.18), (2, (0.05, 0.1, 0.0), 0.22),
                      (5, (0.45, 0.35, 0.4), 0.15)):
        mask[(X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2 <= r**2] = lab
    mask[(X - 0.6) ** 2 + Y**2 + Z**2 <= 0.1**2] = 7  # a label not rendered
    spacing = 2.0
    aff = np.eye(4, dtype=np.float32) * spacing
    aff[3, 3] = 1.0
    aff[:3, 3] = -(N - 1) / 2.0 * spacing
    affinv = np.linalg.inv(aff).astype(np.float32)
    rot = np.array([[2.0, -1.5, 2.5], [0.0, 0.0, 0.0], [-2.5, 1.0, -1.5]], np.float32)
    xyz = np.array([[5.0, 600.0, -8.0], [0.0, 650.0, 0.0], [-6.0, 550.0, 4.0]], np.float32)
    perm = choose_permutation_for_pose(np.eye(3), affinv)
    return dict(density=density, mask=mask, aff=aff, affinv=affinv, rot=rot, xyz=xyz, perm=perm)


def _dets():
    kw = dict(sdd=1020.0, height=H, width=H, delx=2.0, dely=2.0)
    return JDetector(**kw), Detector(**kw)


def _rays_both(s):
    jdet, tdet = _dets()
    jpose = jconvert(jnp.asarray(s["rot"]), jnp.asarray(s["xyz"]), "euler_angles", "ZXY", degrees=True)
    tpose = convert(_t(s["rot"]), _t(s["xyz"]), "euler_angles", "ZXY", degrees=True)
    return jdet.rays(jpose), tdet.rays(tpose)


def test_channel_slab_bounds_match_jax(scene):
    """Bounds equal for every permutation of the axes, and trimmed."""
    for perm in ((0, 1, 2), (1, 2, 0), (2, 0, 1), scene["perm"]):
        ours = tsw.channel_slab_bounds(_t(scene["mask"]), LABELS, perm)
        theirs = jsw.channel_slab_bounds(jnp.asarray(scene["mask"]), LABELS, perm)
        assert ours == theirs
        assert ours[0] == (0, N)
        assert any(k1 - k0 < N for k0, k1 in ours[1:]), ours
    # a label absent from the mask keeps one quantum, as in the JAX package
    assert tsw.channel_slab_bounds(scene["mask"], (9,), (0, 1, 2)) == \
        jsw.channel_slab_bounds(jnp.asarray(scene["mask"]), (9,), (0, 1, 2))


def test_prepare_shearwarp_stack_bit_equal(scene):
    """(C, M, Wd, L) bf16 stacks: channel 0 the full density, the rest the
    per-label masked densities, bit for bit."""
    perm = scene["perm"]
    ours = tsw.prepare_shearwarp(_t(scene["density"]), perm, mask=_t(scene["mask"]), labels=LABELS)
    theirs = jsw.prepare_shearwarp(jnp.asarray(scene["density"]), perm,
                                   mask=jnp.asarray(scene["mask"]), labels=LABELS)
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == tuple(theirs.shape)
    assert ours.shape[0] == 1 + len(LABELS)
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(theirs.astype(jnp.float32)))


@pytest.mark.parametrize("eps", [1.0, 0.25])
def test_channel_forward_matches_jax(scene, eps):
    """The masked fast render (trimmed slab ranges, channels folded into the
    warp) against the JAX package's, in the public [bg, labels...] layout;
    the forward-only render is the same image, and the channels sum to the
    unmasked render."""
    (jsrc, jtgt), (tsrc, ttgt) = _rays_both(scene)
    perm = scene["perm"]
    grid = jsw.default_grid_shape((H, H))
    bounds = tsw.channel_slab_bounds(scene["mask"], LABELS, perm)
    ref = np.asarray(jsw.raymarch_trilinear_fast(
        jnp.asarray(scene["density"]), jnp.asarray(scene["affinv"]), jsrc, jtgt, perm=perm,
        warp_window=grid[0], eps=eps, mask=jnp.asarray(scene["mask"]), labels=LABELS,
        chan_bounds=bounds,
    ))
    kw = dict(perm=perm, eps=eps, mask=_t(scene["mask"]), labels=LABELS, chan_bounds=bounds)
    got = tsw.raymarch_trilinear_fast(_t(scene["density"]), _t(scene["affinv"]), tsrc, ttgt,
                                      **kw).detach().numpy()
    fwd = tsw.raymarch_trilinear_shearwarp(_t(scene["density"]), _t(scene["affinv"]), tsrc, ttgt,
                                           **kw).numpy()
    assert got.shape == ref.shape == (3, 1 + len(LABELS), H * H)
    np.testing.assert_array_equal(fwd, got)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-3 * scale)
    # every label channel carries signal
    assert (np.abs(got[:, 1:]).max(axis=(0, 2)) > 1e-2 * scale).all()
    single = tsw.raymarch_trilinear_shearwarp(_t(scene["density"]), _t(scene["affinv"]), tsrc,
                                              ttgt, perm=perm, eps=eps).numpy()
    np.testing.assert_allclose(got.sum(axis=1), single, rtol=2e-2, atol=2e-3 * scale)


@pytest.mark.parametrize("eps", [1.0, 0.25])
def test_channel_pose_gradient_matches_jax(scene, eps):
    """d(loss)/d(pose) of the registration-style loss of
    tests/test_torch_shearwarp.py (squared error to a golden render at a
    nearby pose), per channel with different weights (background included,
    so the cotangent of the background subtraction reaches every channel),
    against jax.grad: cosine > 0.999, norms within 3%."""
    jdet, tdet = _dets()
    perm = scene["perm"]
    grid = jsw.default_grid_shape((H, H))
    bounds = tsw.channel_slab_bounds(scene["mask"], LABELS, perm)
    w = np.array([0.7, 1.3, 0.9, 2.1], np.float32)[None, :, None]
    r0 = np.array([2.2, -1.3, 2.7, 4.0, 610.0, -7.0], np.float32)
    dens_j, aff_j, mask_j = (jnp.asarray(scene[k]) for k in ("density", "affinv", "mask"))
    # the golden channel render at a nearby pose, as a registration's target
    p_ref = jconvert(jnp.asarray(scene["rot"][:1]), jnp.asarray(scene["xyz"][:1]),
                     "euler_angles", "ZXY", degrees=True)
    target = np.asarray(jxla.raymarch_trilinear(dens_j, aff_j, *jdet.rays(p_ref), n_samples=512,
                                                mask=mask_j, labels=LABELS))

    def jloss(r6):
        p = jconvert(r6[None, :3], r6[None, 3:], "euler_angles", "ZXY", degrees=True)
        img = jsw.raymarch_trilinear_fast(dens_j, aff_j, *jdet.rays(p), perm=perm,
                                          warp_window=grid[0], eps=eps, mask=mask_j,
                                          labels=LABELS, chan_bounds=bounds)
        return jnp.sum(jnp.asarray(w) * (img - jnp.asarray(target)) ** 2)

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(r0)))
    r6 = torch.tensor(r0, requires_grad=True)
    p = convert(r6[None, :3], r6[None, 3:], "euler_angles", "ZXY", degrees=True)
    img = tsw.raymarch_trilinear_fast(_t(scene["density"]), _t(scene["affinv"]), *tdet.rays(p),
                                      perm=perm, eps=eps, mask=_t(scene["mask"]), labels=LABELS,
                                      chan_bounds=bounds)
    (_t(w) * (img - _t(target)) ** 2).sum().backward()
    tg = r6.grad.numpy()
    cos = float(np.dot(jg, tg) / (np.linalg.norm(jg) * np.linalg.norm(tg)))
    ratio = float(np.linalg.norm(tg) / np.linalg.norm(jg))
    assert cos > 0.999, (cos, jg, tg)
    assert abs(ratio - 1.0) < 0.03, (ratio, jg, tg)


def test_projector_channels_match_jax(scene):
    """A masked Projector: with_shearwarp fixes the JAX package's renderer,
    permutation and channel bounds, and renders its image (B, C, H, W)."""
    pose_args = (scene["rot"], scene["xyz"])
    jvol = JVolume(jnp.asarray(scene["density"] * 1000.0 - 200.0), jnp.asarray(scene["aff"]),
                   mask=jnp.asarray(scene["mask"]))
    tvol = Volume(_t(scene["density"] * 1000.0 - 200.0), _t(scene["aff"]), mask=_t(scene["mask"]))
    kw = dict(sdd=1020.0, height=H, delx=2.0, labels=LABELS)
    jp = JProjector.from_volume(jvol, **kw)
    tp = Projector.from_volume(tvol, **kw)
    jpose = jconvert(*(jnp.asarray(a) for a in pose_args), "euler_angles", "ZXY", degrees=True)
    tpose = convert(*(_t(a) for a in pose_args), "euler_angles", "ZXY", degrees=True)
    js, ts = jp.with_shearwarp(jpose[:1]), tp.with_shearwarp(tpose[:1])
    assert (ts.renderer, ts.pallas_perm, ts.shearwarp_bounds) == \
        (js.renderer, js.pallas_perm, js.shearwarp_bounds)
    ref = np.asarray(js.replace(shearwarp_window=jsw.default_grid_shape((H, H))[0])(jpose))
    prepared = ts.prepare_for_shearwarp()
    assert tuple(prepared.shape) == (1 + len(LABELS), N, N, N)
    got = ts(tpose, prepared=prepared).detach().numpy()
    assert got.shape == (3, 1 + len(LABELS), H, H)
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-3 * np.abs(ref).max())


def test_channel_slab_backward_refused(scene):
    (_, _), (tsrc, ttgt) = _rays_both(scene)
    with pytest.raises(ValueError, match="channel"):
        tsw.raymarch_trilinear_fast(_t(scene["density"]), _t(scene["affinv"]), tsrc, ttgt,
                                    perm=scene["perm"], mask=_t(scene["mask"]), labels=LABELS,
                                    backward="slab")
