"""The port's similarity metrics, X-ray transforms and geodesics against the
JAX package's (CPU), on the same NumPy inputs, at rtol 1e-4: both compute in
float32 and differ only in summation order (the atol covers scores near 0).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvr_tpu.geometry import convert as jconvert
from xvr_tpu.metrics import double_geodesic as j_double_geodesic
from xvr_tpu.utils import transforms as jtr
from xvr_tpu_torch.geometry import convert
from xvr_tpu_torch.metrics import double_geodesic
from xvr_tpu_torch.utils import transforms as ttr
from torch_threads import two_torch_threads  # noqa: F401

# the modules (each package re-exports a function named ``ncc``)
jncc = importlib.import_module("xvr_tpu.metrics.ncc")
ncc = importlib.import_module("xvr_tpu_torch.metrics.ncc")

RTOL, ATOL = 1e-4, 1e-5


def close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def _pair(seed, shape=(3, 1, 40, 36)):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, shape).astype(np.float32)
    y = (0.7 * x + 0.3 * rng.normal(0.0, 1.0, shape)).astype(np.float32)
    y[1] = rng.uniform(0, 1, shape[1:]).astype(np.float32)  # an unrelated image
    y[2, :, :10] = 0.0  # a flat region
    return x, y


def test_global_ncc_matches_jax():
    x, y = _pair(0)
    close(ncc.ncc(torch.as_tensor(x), torch.as_tensor(y)), jncc.ncc(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("patch", [5, 9, 11])
def test_local_ncc_matches_jax(patch):
    x, y = _pair(1)
    close(ncc.local_ncc(torch.as_tensor(x), torch.as_tensor(y), patch),
          jncc.local_ncc(jnp.asarray(x), jnp.asarray(y), patch))


def test_multiscale_ncc_matches_jax():
    x, y = _pair(2)
    close(ncc.multiscale_ncc(torch.as_tensor(x), torch.as_tensor(y), (None, 9), (0.5, 0.5)),
          jncc.multiscale_ncc(jnp.asarray(x), jnp.asarray(y), (None, 9), (0.5, 0.5)))


@pytest.mark.parametrize("sigma", [0.0, 1.0])
def test_gradient_ncc_matches_jax(sigma):
    x, y = _pair(3)
    close(ncc.gradient_ncc(torch.as_tensor(x), torch.as_tensor(y), 11, sigma),
          jncc.gradient_ncc(jnp.asarray(x), jnp.asarray(y), 11, sigma))
    close(ncc.sobel(torch.as_tensor(x)), jncc.sobel(jnp.asarray(x)))


def test_imagesim_and_its_gradient_match_jax():
    """The registrar's similarity and its input gradient (what the pose
    gradient flows through)."""
    import jax

    x, y = _pair(4)
    jf = jncc.make_imagesim(9, 11, 0.0, 0.5)
    tf = ncc.make_imagesim(9, 11, 0.0, 0.5)
    close(tf(torch.as_tensor(x), torch.as_tensor(y)), jf(jnp.asarray(x), jnp.asarray(y)))
    jg = jax.grad(lambda b: jf(jnp.asarray(x), b).sum())(jnp.asarray(y))
    yt = torch.as_tensor(y).requires_grad_(True)
    tf(torch.as_tensor(x), yt).sum().backward()
    close(yt.grad, jg, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("shape,out", [
    ((2, 1, 40, 40), (40, 40)),  # identity
    ((2, 1, 64, 48), (16, 12)),  # antialiased downsampling
    ((1, 1, 67, 53), (24, 19)),  # non-integer factors
    ((1, 1, 12, 10), (30, 25)),  # upsampling
])
def test_resize_matches_jax(shape, out):
    x = np.random.default_rng(5).uniform(0, 1, shape).astype(np.float32)
    close(ttr.resize(torch.as_tensor(x), *out), jtr.resize(jnp.asarray(x), *out))


@pytest.mark.parametrize("use_equalize", [False, True])
def test_xray_transforms_match_jax(use_equalize):
    x = np.random.default_rng(6).gamma(2.0, 1.0, (2, 1, 48, 40)).astype(np.float32)
    tt = ttr.make_xray_transforms(24, 20, use_equalize=use_equalize)
    jt = jtr.make_xray_transforms(24, 20, use_equalize=use_equalize)
    close(tt(torch.as_tensor(x)), jt(jnp.asarray(x)), rtol=1e-4, atol=1e-4)
    close(ttr.standardize(torch.as_tensor(x)), jtr.standardize(jnp.asarray(x)))
    close(ttr.center_crop(torch.as_tensor(x), 30, 50), jtr.center_crop(jnp.asarray(x), 30, 50))


def test_double_geodesic_matches_jax():
    rng = np.random.default_rng(7)
    r1, r2 = rng.normal(0, 0.3, (2, 5, 3)).astype(np.float32)
    t1, t2 = rng.normal(0, 20, (2, 5, 3)).astype(np.float32)
    r2[0], t2[0] = r1[0], t1[0]  # identical poses: exactly zero
    j = j_double_geodesic(jconvert(jnp.asarray(r1), jnp.asarray(t1), "euler_angles", "ZXY"),
                          jconvert(jnp.asarray(r2), jnp.asarray(t2), "euler_angles", "ZXY"), 1020.0)
    t = double_geodesic(convert(torch.as_tensor(r1), torch.as_tensor(t1), "euler_angles", "ZXY"),
                        convert(torch.as_tensor(r2), torch.as_tensor(t2), "euler_angles", "ZXY"), 1020.0)
    for a, b in zip(t, j):
        close(a, b, rtol=1e-4, atol=1e-2)
    assert float(t[2][0]) == 0.0
