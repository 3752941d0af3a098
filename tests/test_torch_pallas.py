"""Parity of the port's slab renderer (K5-K8) and golden renderers with the
JAX package (CPU).

On the same NumPy inputs, each JAX function (its Pallas kernels in interpret
mode, with a window that spans the whole transverse extent so it never
clips, as the JAX package's own tests run them) is held against its port
counterpart, whose kernels run as their plain PyTorch versions on CPU
tensors. Both sides read the same bf16 volume and compute in float32, so
they agree to float32 rounding: renders to atol 1e-5 * max + rtol 1e-5, pose
gradients (sums of signed terms) to atol 1e-4 * max. Scenes are small (16^3
volume, 8 x 8 detector), as in tests/test_pallas.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvr_tpu.geometry import Detector as JDetector
from xvr_tpu.geometry import convert as jconvert
from xvr_tpu.render import Projector as JProjector
from xvr_tpu.render import Volume as JVolume
from xvr_tpu.render import make_test_volume
from xvr_tpu.render import pallas as jpallas
from xvr_tpu.render import xla as jxla
from xvr_tpu_torch.geometry import convert
from xvr_tpu_torch.render import Projector, Volume
from xvr_tpu_torch.render import pallas as tpallas
from xvr_tpu_torch.render import xla as txla
from xvr_tpu_torch.state import from_numpy_state
from torch_threads import two_torch_threads  # noqa: F401

N = 16
PERM = (1, 0, 2)  # beam along y: march y, window x, lane z
ROT = [[0.05, 0.03, -0.04], [-0.03, 0.06, 0.02]]
XYZ = [[0.5, 200.0, 1.5], [-1.0, 190.0, 0.8]]


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _close(got, ref, rtol=1e-5, atol_rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=atol_rel * max(np.abs(ref).max(), 1e-12))


def _scene(kind, n=N, B=2):
    """(JAX volume, density, affine inverse, source, target) for B poses of an
    8 x 8 detector at 400 mm."""
    vol = make_test_volume(n, spacing=2.0, kind=kind)
    det = JDetector(sdd=400.0, height=8, width=8, delx=4.0, dely=4.0)
    pose = jconvert(jnp.asarray(ROT[:B], jnp.float32), jnp.asarray(XYZ[:B], jnp.float32),
                    "euler_angles", "ZXY")
    src, tgt = det.rays(pose)
    return vol, np.asarray(vol.data), np.asarray(vol.affine_inverse), np.asarray(src), np.asarray(tgt)


def _mask(dens):
    """Labels 1 (density > 0.3) and 2 (> 0.6), 0 elsewhere."""
    return ((dens > 0.3).astype(np.int32) + (dens > 0.6)).astype(np.int32)


@pytest.mark.parametrize("kind", ["gradient", "sphere", "random"])
def test_slab_forward_matches_jax(kind):
    """K5 through raymarch_trilinear_pallas, with and without a given perm."""
    vol, dens, A, S, T = _scene(kind)
    ref = jpallas.raymarch_trilinear_pallas(vol.data, vol.affine_inverse, S, T, window=N,
                                            perm=PERM)
    got = tpallas.raymarch_trilinear_pallas(_t(dens), _t(A), _t(S), _t(T), perm=PERM)
    assert got.shape == (2, 64)
    _close(got, ref)
    # the permutation probed from the rays is the JAX package's
    auto = tpallas.raymarch_trilinear_pallas(_t(dens), _t(A), _t(S), _t(T))
    _close(auto, ref)


@pytest.mark.parametrize("kind", ["gradient", "random"])
def test_slab_pose_gradient_matches_jax(kind):
    """The gradient through _SlabCore (K6) against jax.grad through the JAX
    package's custom VJP (its _kernel_bwd), with respect to both ray ends."""
    vol, dens, A, S, T = _scene(kind)
    w = np.random.default_rng(0).normal(size=(2, 64)).astype(np.float32)

    def jloss(s, t):
        out = jpallas.raymarch_trilinear_pallas(vol.data, vol.affine_inverse, s, t, window=N,
                                                perm=PERM)
        return jnp.sum(out * w)

    jg_s, jg_t = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(S), jnp.asarray(T))
    ts, tt = _t(S).requires_grad_(True), _t(T).requires_grad_(True)
    out = tpallas.raymarch_trilinear_pallas(_t(dens), _t(A), ts, tt, perm=PERM)
    (out * _t(w)).sum().backward()
    for got, ref in ((ts.grad, jg_s), (tt.grad, jg_t)):
        assert float(np.abs(np.asarray(ref)).max()) > 0
        _close(got, ref, rtol=1e-4, atol_rel=1e-4)


def test_slab_channels_and_gradient_match_jax():
    """K7's channels against the JAX channel kernel, their sum against K5,
    and the mean-cotangent gradient (K6) against jax.grad."""
    vol, dens, A, S, T = _scene("gradient")
    mask = _mask(dens)
    kw = dict(window=N, perm=PERM, mask=jnp.asarray(mask), labels=(1, 2))
    ref = jpallas.raymarch_trilinear_pallas(vol.data, vol.affine_inverse, S, T, **kw)
    got = tpallas.raymarch_trilinear_pallas(_t(dens), _t(A), _t(S), _t(T), perm=PERM,
                                            mask=_t(mask), labels=(1, 2))
    assert got.shape == (2, 3, 64)
    _close(got, ref)
    assert all(float(got[:, c].max()) > 0 for c in range(3))
    plain = tpallas.raymarch_trilinear_pallas(_t(dens), _t(A), _t(S), _t(T), perm=PERM)
    _close(got.sum(dim=1), plain)

    w = np.random.default_rng(1).normal(size=(2, 3, 64)).astype(np.float32)
    jg = jax.grad(lambda t: jnp.sum(jpallas.raymarch_trilinear_pallas(
        vol.data, vol.affine_inverse, S, t, **kw) * w))(jnp.asarray(T))
    tt = _t(T).requires_grad_(True)
    (tpallas.raymarch_trilinear_pallas(_t(dens), _t(A), _t(S), tt, perm=PERM, mask=_t(mask),
                                       labels=(1, 2)) * _t(w)).sum().backward()
    _close(tt.grad, jg, rtol=1e-4, atol_rel=1e-4)


@pytest.mark.parametrize("kind", ["gradient", "sphere", "random"])
def test_siddon_pallas_matches_jax(kind):
    """K8 against the JAX Siddon kernel, and within the JAX package's 1% of
    max of the golden DDA (tests/test_pallas.py). It is forward only."""
    vol, dens, A, S, T = _scene(kind)
    ref = jpallas.raymarch_siddon_pallas(vol.data, vol.affine_inverse, S, T, window=N, perm=PERM)
    got = tpallas.raymarch_siddon_pallas(_t(dens), _t(A), _t(S), _t(T), perm=PERM)
    _close(got, ref)
    gold = txla.raymarch_siddon(_t(dens), _t(A), _t(S), _t(T))
    assert float((got - gold).abs().max() / gold.abs().max()) < 0.01
    tt = _t(T).requires_grad_(True)
    out = tpallas.raymarch_siddon_pallas(_t(dens), _t(A), _t(S), tt, perm=PERM)
    with pytest.raises(RuntimeError, match="forward only"):
        out.sum().backward()


def test_siddon_pallas_labels_take_the_golden_dda():
    """With a labelmap, siddon_pallas renders through the golden DDA, as the
    JAX package routes it."""
    vol, dens, A, S, T = _scene("sphere", B=1)
    mask = _mask(dens)
    ref = jpallas.raymarch_siddon_pallas(vol.data, vol.affine_inverse, S, T, mask=jnp.asarray(mask),
                                         labels=(1, 2))
    got = tpallas.raymarch_siddon_pallas(_t(dens), _t(A), _t(S), _t(T), mask=_t(mask),
                                         labels=(1, 2))
    assert got.shape == (1, 3, 64)
    _close(got, ref)


def test_golden_siddon_and_gradient_match_jax():
    """xla.raymarch_siddon (the exact DDA) and its autograd gradient against
    the JAX DDA and jax.grad: float32 on both sides (rtol 1e-4; the crossing
    parameters cancel, so the gradient to atol 1e-3 * max)."""
    vol, dens, A, S, T = _scene("random", n=12)
    ref = jxla.raymarch_siddon(vol.data, vol.affine_inverse, S, T)
    got = txla.raymarch_siddon(_t(dens), _t(A), _t(S), _t(T))
    _close(got, ref, rtol=1e-4, atol_rel=1e-5)
    w = np.random.default_rng(2).normal(size=ref.shape).astype(np.float32)
    jg = jax.grad(lambda t: jnp.sum(jxla.raymarch_siddon(vol.data, vol.affine_inverse, S, t) * w))(
        jnp.asarray(T))
    tt = _t(T).requires_grad_(True)
    (txla.raymarch_siddon(_t(dens), _t(A), _t(S), tt) * _t(w)).sum().backward()
    assert float(np.abs(np.asarray(jg)).max()) > 0
    _close(tt.grad, jg, rtol=1e-3, atol_rel=1e-3)


def test_golden_label_channels_match_jax():
    """Nearest-label channels of the golden trilinear renderer, whole and in
    ray chunks, and of the golden Siddon renderer."""
    vol, dens, A, S, T = _scene("gradient")
    mask = _mask(dens)
    ref = jxla.raymarch_trilinear(vol.data, vol.affine_inverse, S, T, n_samples=48,
                                  mask=jnp.asarray(mask), labels=(1, 2))
    got = txla.raymarch_trilinear(_t(dens), _t(A), _t(S), _t(T), n_samples=48, mask=_t(mask),
                                  labels=(1, 2))
    assert got.shape == (2, 3, 64)
    _close(got, ref, rtol=1e-4, atol_rel=1e-4)
    chunked = txla.raymarch_trilinear(_t(dens), _t(A), _t(S), _t(T), n_samples=48,
                                      mask=_t(mask), labels=(1, 2), ray_chunk=23)
    _close(chunked, got, rtol=1e-6, atol_rel=1e-6)
    ref_s = jxla.raymarch_siddon(vol.data, vol.affine_inverse, S, T, mask=jnp.asarray(mask),
                                 labels=(1, 2))
    got_s = txla.raymarch_siddon(_t(dens), _t(A), _t(S), _t(T), mask=_t(mask), labels=(1, 2))
    _close(got_s, ref_s, rtol=1e-4, atol_rel=1e-5)


def _projectors(kind="gradient", height=8, delx=4.0):
    vol = make_test_volume(N, spacing=2.0, kind=kind)
    data, aff = np.asarray(vol.data), np.asarray(vol.affine)
    jp = JProjector.from_volume(JVolume(jnp.asarray(data), jnp.asarray(aff)), sdd=400.0,
                                height=height, delx=delx)
    tp = Projector.from_volume(Volume(_t(data), _t(aff)), sdd=400.0, height=height, delx=delx)
    return jp, tp


def _poses(rot_deg, xyz):
    r, x = np.asarray(rot_deg, np.float32), np.asarray(xyz, np.float32)
    return (jconvert(jnp.asarray(r), jnp.asarray(x), "euler_angles", "ZXY", degrees=True),
            convert(_t(r), _t(x), "euler_angles", "ZXY", degrees=True))


def test_with_pallas_matches_jax():
    """with_pallas picks the JAX package's permutation, renders its image,
    and keeps the golden renderer where rays pass 45 degrees of the march
    axis (steepness > 1.2)."""
    jp, tp = _projectors()
    jpose, tpose = _poses([[180.0, 2.0, -3.0]], [[0.0, 200.0, 0.0]])
    js = jp.with_pallas(jpose, window=N)
    ts = tp.with_pallas(tpose)
    assert (ts.renderer, ts.pallas_perm) == (js.renderer, js.pallas_perm) == (
        "trilinear_pallas", js.pallas_perm)
    assert ts.pallas_window == tp.pallas_window  # nothing to measure on the GPU
    assert ts.measure_window(tpose) == ts.pallas_window
    _close(ts(tpose).detach(), js(jpose))
    prepared = ts.prepare()  # the slab kernels' operand; the golden renderer has none
    assert torch.equal(prepared[0], ts.pack_for_pallas()[0]) and tp.prepare() is None
    _close(ts(tpose, prepared=prepared).detach(), js(jpose))
    # beam at 45 deg between two volume axes plus a wide field of view
    jw, tw = _projectors(height=16, delx=12.0)
    jdiag, tdiag = _poses([[225.0, 0.0, 0.0]], [[0.0, 200.0, 0.0]])
    assert tw.with_pallas(tdiag).renderer == jw.with_pallas(jdiag).renderer == "trilinear"


def test_projector_renders_the_siddon_renderers_like_jax():
    """The ``siddon`` (golden DDA) and ``siddon_pallas`` (K8) renderers."""
    jp, tp = _projectors(kind="sphere")
    jpose, tpose = _poses([[180.0, 2.0, -3.0]], [[1.0, 200.0, -1.0]])
    for name in ("siddon", "siddon_pallas"):
        ref = jp.replace(renderer=name, pallas_perm=PERM, pallas_window=N)(jpose)
        got = tp.replace(renderer=name, pallas_perm=PERM)(tpose)
        _close(got, ref, rtol=1e-4)


def test_from_numpy_state_slab_projector_renders_like_jax():
    """A JAX slab projector with a labelmap, handed over as NumPy arrays and
    plain values, renders the same channels in the port."""
    vol = make_test_volume(N, spacing=2.0, kind="gradient")
    mask = _mask(np.asarray(vol.data))
    jv = JVolume(vol.data, vol.affine, mask=jnp.asarray(mask))
    jpose, _ = _poses([[180.0, 2.0, -3.0]], [[0.0, 200.0, 0.0]])
    jp = JProjector.from_volume(jv, sdd=400.0, height=8, delx=4.0, labels=(1, 2))
    jp = jp.with_pallas(jpose, window=N)
    proj, _, pose = from_numpy_state(
        np.asarray(jv.data), np.asarray(jv.affine), detector=dataclasses.asdict(jp.detector),
        mask=mask, density=np.asarray(jp.density), renderer=jp.renderer, labels=jp.labels,
        n_samples=jp.n_samples, pallas_perm=jp.pallas_perm, pallas_window=jp.pallas_window,
        pallas_remap=jp.pallas_remap, pose=np.asarray(jpose.matrix), device="cpu",
    )
    assert (proj.renderer, proj.labels, proj.pallas_perm) == ("trilinear_pallas", (1, 2),
                                                              jp.pallas_perm)
    ref = jp(jpose)
    got = proj(pose)
    assert got.shape == (1, 3, 8, 8)
    _close(got, ref)


def test_pack_labels_and_table_bytes():
    mask = np.arange(-2, 22).reshape(2, 3, 4) * 20
    packed = tpallas.pack_labels(_t(mask), (2, 0, 1))
    assert packed.dtype == torch.uint8 and tuple(packed.shape) == (4, 2, 3)
    want = np.transpose(np.where(mask < 0, 255, np.clip(mask, 0, 255)), (2, 0, 1))
    np.testing.assert_array_equal(packed.numpy(), want)
    table, shape = tpallas.pack_density(torch.rand(5, 6, 7), (1, 2, 0))
    assert table.dtype == torch.bfloat16 and shape == (6, 7, 5)
    assert tpallas.packed_table_bytes((256, 256, 256)) == 256**3 * 2
    assert tpallas.packed_table_bytes(torch.zeros(3, 4, 5), (2, 0, 1)) == 3 * 4 * 5 * 2


def test_plain_backward_matches_finite_differences():
    """The plain K6 in float64 against a central difference of the plain K5
    in float64, along a random direction in the seven fields: the two agree
    up to the sampled tent kinks a step of 1e-6 voxel crosses."""
    vol, dens, A, S, T = _scene("sphere")
    table = tpallas.pack_density(_t(dens), PERM)[0]
    from xvr_tpu_torch.render.shearwarp import _decompose

    fields = tpallas._fields(*_decompose(_t(A), _t(S), _t(T), PERM)).double()
    rng = np.random.default_rng(3)
    g = _t(rng.normal(size=fields.shape[1:]), torch.float64)
    e = _t(rng.normal(size=fields.shape), torch.float64)
    e[6] *= float(fields[6].abs().mean())
    grad = tpallas._slab_backward(table, fields, g)
    h = 1e-6
    fd = ((tpallas._slab_forward(table, fields + h * e) - tpallas._slab_forward(table, fields - h * e))
          * g).sum() / (2 * h)
    an = (grad * e).sum()
    assert abs(float(an - fd)) <= 1e-4 * abs(float(fd)), (float(an), float(fd))
