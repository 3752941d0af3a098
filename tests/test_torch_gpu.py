"""The hand-written CUDA kernels against their plain versions, on the card.

Run on a machine with an NVIDIA GPU (sm_90a) and nvcc: ``pytest -m gpu``.
Elsewhere every test skips; the decision is made in a fixture, so every
worker collects the same tests. References are the plain versions with
``bf16=False`` (the kernels' own arithmetic) in float64, except for K4, whose
hat' jumps at integer positions: its reference computes positions in float32
exactly as the kernel does. Tolerances are those of chip_smoke.py.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m gpu` on the card")
    return torch.device("cuda")


def _inputs(dev, seed, sgnval, B=5, M=24, Wd=20, L=36, Iu=32, Iv=48):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    vol = f(rng.uniform(0.0, 1.0, (M, Wd, L))).to(torch.bfloat16)
    s_p = f(rng.normal(0.0, 2.0, (B, 3)) + np.array([-8.0, 9.0, 17.0]))
    args = (s_p, f(np.full(B, sgnval)), f(rng.normal(-0.3, 0.05, B)), f(rng.uniform(0.01, 0.03, B)),
            f(rng.normal(-0.5, 0.05, B)), f(rng.uniform(0.01, 0.03, B)))
    return vol, args, (Iu, Iv)


CASES = [(1.0, 0, None, 1.0), (0.25, 0, None, 1.0), (1.0, 3, 17, -1.0), (0.25, 5, 20, -1.0)]


@pytest.mark.parametrize("eps,k0,k1,sgnval", CASES)
def test_accumulate_kernel_matches_plain(cuda, eps, k0, k1, sgnval):
    from xvr_tpu_torch.render import shearwarp as sw

    vol, args, (Iu, Iv) = _inputs(cuda, 0, sgnval)
    kw = dict(Iu=Iu, Iv=Iv, eps=eps, k0=k0, k1=k1)
    got = sw.accumulate(vol, *args, **kw).double()
    ref = sw._accumulate(vol, *[a.double() for a in args], bf16=False, **kw)
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("eps,k0,k1,sgnval", CASES)
def test_adjoint_kernel_matches_plain(cuda, eps, k0, k1, sgnval):
    from xvr_tpu_torch.render import shearwarp as sw

    vol, args, (Iu, Iv) = _inputs(cuda, 1, sgnval)
    ibar = torch.randn((5, Iu, Iv), generator=torch.Generator(cuda).manual_seed(2), device=cuda)
    kw = dict(Iu=Iu, Iv=Iv, eps=eps, k0=k0, k1=k1)
    got = sw.accumulate_adjoint(vol, *args, ibar, **kw)
    ref = sw._accumulate_adjoint(vol, *args, ibar, bf16=False, **kw)
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-4 * float(ref.abs().max()))


def test_warp_kernels_match_plain(cuda):
    from xvr_tpu_torch.render import shearwarp as sw

    g = torch.Generator(cuda).manual_seed(3)
    B, Iu, Iv, R = 3, 32, 48, 500
    I = torch.rand((B, Iu, Iv), generator=g, device=cuda)
    uc = torch.rand((B, R), generator=g, device=cuda) * (Iu + 3) - 2
    vc = torch.rand((B, R), generator=g, device=cuda) * (Iv + 2) - 1.5
    ws = torch.rand((B, R), generator=g, device=cuda) * 2.2 - 0.2
    d = lambda *xs: [x.double() for x in xs]  # noqa: E731
    ref = sw._warp_plain(*d(I, uc, vc, ws), bf16=False)
    torch.testing.assert_close(sw.warp(I, uc, vc, ws).double(), ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
    for got, r in zip(sw.warp_with_grads(I, uc, vc, ws),
                      sw._warp_with_grads_plain(*d(I, uc, vc, ws), bf16=False)):
        torch.testing.assert_close(got.double(), r, rtol=0, atol=1e-5)


def test_fast_render_launches_every_kernel(cuda):
    """A fast render and its backward go through K1-K4, and only there."""
    from xvr_tpu_torch.geometry import Detector, convert
    from xvr_tpu_torch.render import _cuda, raymarch_trilinear_fast

    n = 40
    g = torch.Generator(cuda).manual_seed(4)
    density = torch.rand((n, n, n), generator=g, device=cuda)
    affinv = torch.eye(4, device=cuda) / 2.0
    affinv[3, 3] = 1.0
    affinv[:3, 3] = (n - 1) / 2.0
    rot = torch.tensor([[180.0, 2.0, -3.0], [178.0, -1.0, 2.0]], device=cuda, requires_grad=True)
    xyz = torch.tensor([[0.0, 500.0, 0.0], [3.0, 520.0, -2.0]], device=cuda)
    det = Detector(sdd=1000.0, height=32, width=32, delx=3.0, dely=3.0)
    _cuda.reset_launches()
    src, tgt = det.rays(convert(rot, xyz, "euler_angles", "ZXY", degrees=True))
    img = raymarch_trilinear_fast(density, affinv, src, tgt)
    (img**2).sum().backward()
    torch.cuda.synchronize()
    assert all(v == 1 for v in _cuda.LAUNCHES.values()), _cuda.LAUNCHES
    assert torch.isfinite(img).all() and torch.isfinite(rot.grad).all()
    assert float(rot.grad.abs().sum()) > 0


def test_wrappers_check_their_inputs(cuda):
    from xvr_tpu_torch.render import _cuda

    vol = torch.zeros((4, 5, 6), device=cuda)  # float32, not bf16
    with pytest.raises(TypeError, match="bfloat16"):
        _cuda.accumulate(vol, torch.zeros((2, 8), device=cuda), Iu=8, Iv=8, eps=1.0, k0=0, k1=4)
    with pytest.raises(ValueError, match="slab bounds"):
        _cuda.accumulate(vol.bfloat16(), torch.zeros((2, 8), device=cuda), Iu=8, Iv=8, eps=1.0,
                         k0=0, k1=9)
