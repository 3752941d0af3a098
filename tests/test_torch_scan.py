"""The memory-lean trilinear march (``raymarch_trilinear_scan``) against the
JAX package's (CPU).

Both accumulate the midpoint samples depth by depth in float32 and scale the
sum once, so they agree to rtol 1e-5; the sample-tensor renderer
(``raymarch_trilinear``) scales each sample first and agrees to float32
round-off of the sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvr_tpu.geometry import Detector as JDetector, convert as jconvert
from xvr_tpu.render import xla as jxla
from xvr_tpu_torch.geometry import Detector, convert
from xvr_tpu_torch.render import xla
from torch_threads import two_torch_threads  # noqa: F401

N, H = 24, 20


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(3)
    c = (N - 1) / 2
    X, Y, Z = np.meshgrid(*([np.arange(N)] * 3), indexing="ij")
    r2 = (X - c) ** 2 + (Y - c) ** 2 + (Z - c) ** 2
    density = np.where(r2 <= (N / 2.5) ** 2, 0.2 + 0.01 * Y, 0.0).astype(np.float32)
    density += rng.uniform(0.0, 0.05, density.shape).astype(np.float32)
    aff = np.diag([3.0, 2.5, 2.0, 1.0]).astype(np.float32)
    aff[:3, 3] = [-30.0, -28.0, -20.0]
    affinv = np.linalg.inv(aff).astype(np.float32)
    rot = np.array([[178.0, 3.0, -4.0], [183.0, -2.0, 1.0], [90.0, 10.0, 0.0]], np.float32)
    xyz = np.array([[2.0, 400.0, -3.0], [-4.0, 380.0, 5.0], [0.0, 10.0, 0.0]], np.float32)
    jdet = JDetector(sdd=800.0, height=H, width=H + 4, delx=4.0, dely=3.5)
    tdet = Detector(sdd=800.0, height=H, width=H + 4, delx=4.0, dely=3.5)
    jrays = jdet.rays(jconvert(jnp.asarray(rot), jnp.asarray(xyz), "euler_angles", "ZXY",
                               degrees=True))
    trays = tdet.rays(convert(torch.as_tensor(rot), torch.as_tensor(xyz), "euler_angles", "ZXY",
                              degrees=True))
    return density, affinv, jrays, trays


@pytest.mark.parametrize("n_samples", [64, 37])
def test_scan_matches_jax_scan(scene, n_samples):
    """Poses in front of the volume and one with its source inside it."""
    density, affinv, (jsrc, jtgt), (tsrc, ttgt) = scene
    ref = np.asarray(jxla.raymarch_trilinear_scan(jnp.asarray(density), jnp.asarray(affinv),
                                                  jsrc, jtgt, n_samples=n_samples))
    got = xla.raymarch_trilinear_scan(torch.as_tensor(density), torch.as_tensor(affinv), tsrc, ttgt,
                                      n_samples=n_samples)
    assert got.shape == ttgt.shape[:2] and np.abs(ref).max() > 0
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_scan_matches_sample_tensor_renderer(scene):
    density, affinv, _, (tsrc, ttgt) = scene
    args = (torch.as_tensor(density), torch.as_tensor(affinv), tsrc, ttgt)
    ref = xla.raymarch_trilinear(*args, n_samples=64)
    got = xla.raymarch_trilinear_scan(*args, n_samples=64)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
