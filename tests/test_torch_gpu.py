"""The hand-written CUDA kernels against their plain versions, on the card.

Run on a machine with an NVIDIA GPU (sm_90a) and nvcc: ``pytest -m gpu``.
Elsewhere every test skips; the decision is made in a fixture, so every
worker collects the same tests. References are the plain versions with
``bf16=False`` (the kernels' own arithmetic) in float64, except for K4, whose
hat' jumps at integer positions: its reference computes positions in float32
exactly as the kernel does. The slab kernels follow the same rule: K5 and K8
(positive terms) against float64, K6 (tent slopes that flip where a sample
crosses a row) and K7 (nearest-label rounding) against float32 plain
versions with identical positions. Tolerances are those of chip_smoke.py.
"""

import importlib.util
from pathlib import Path

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
    assert torch.equal(got, sw.accumulate_adjoint(vol, *args, ibar, **kw))


# Beyond the path's inputs: a tile's rows span more than one staged chunk
# (steep rows), its lanes limit a chunk to a few rows (wide lanes), whole
# tiles sit at floor(wpos) = -1 and floor(lpos) = L - 1 of an odd-L volume
# (plain loads instead of cp.async), and a volume of 2500 lanes whose boxes
# grow past a chunk's 2048 bf16 (read from global memory); every grid is
# ragged. At 2500 lanes one float32 ulp of a position is 2.4e-4 lane, so that
# case takes binary-fraction geometry whose float32 positions are exact, and
# the float64 reference sees the kernel's positions.
EDGE_CASES = {
    "steep_rows": dict(M=24, Wd=96, L=36, Iu=40, Iv=70, s=(-8.0, 48.0, 18.0), u=(-2.5, 0.25),
                       v=(-0.5, 0.03)),
    "wide_lanes": dict(M=6, Wd=40, L=500, Iu=20, Iv=80, s=(-12.0, 20.0, 250.0), u=(-0.6, 0.06),
                       v=(-15.0, 0.375)),
    "edge_odd_lanes": dict(M=24, Wd=20, L=37, Iu=20, Iv=40, s=(-8.0, -0.5, 36.5), u=(0.0, 0.001),
                           v=(0.0, 0.001)),
    "wide_volume": dict(M=6, Wd=20, L=2500, Iu=24, Iv=70, s=(-12.0, 10.0, 1250.0),
                        u=(-0.25, 1 / 64), v=(-85.0, 2.5), exact=True),
}


def _edge_inputs(dev, seed, M, Wd, L, Iu, Iv, s, u, v, B=3, exact=False):
    """Per image, the case's geometry moved by a random jitter, or with
    ``exact`` by binary fractions (source offsets of 1/8 and 1/4, slopes
    scaled by 1.25 and 0.75)."""
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    vol = f(rng.uniform(0.0, 1.0, (M, Wd, L))).to(torch.bfloat16)
    if exact:
        ds = np.arange(B)[:, None] * np.array([0.25, 0.125, 0.125])
        jit = lambda x: f(x * np.array([1.0, 1.25, 0.75])[:B])  # noqa: E731
    else:
        ds = rng.normal(0.0, 0.2, (B, 3))
        jit = lambda x: f(x * (1.0 + rng.uniform(-0.05, 0.05, B)))  # noqa: E731
    args = (f(np.array(s) + ds), f(np.ones(B)), jit(u[0]), jit(u[1]), jit(v[0]), jit(v[1]))
    return vol, args, (Iu, Iv)


@pytest.mark.parametrize("eps", [1.0, 0.25])
@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_tiled_kernels_steep_and_edge(cuda, case, eps):
    """K1 and K4 on geometry the bench does not reach, against their plain
    versions with the tolerances above; two calls give identical bits."""
    from xvr_tpu_torch.render import shearwarp as sw

    vol, args, (Iu, Iv) = _edge_inputs(cuda, 3, **EDGE_CASES[case])
    kw = dict(Iu=Iu, Iv=Iv, eps=eps)
    got = sw.accumulate(vol, *args, **kw)
    ref = sw._accumulate(vol, *[a.double() for a in args], bf16=False, **kw)
    assert float(ref.abs().max()) > 0
    torch.testing.assert_close(got.double(), ref, rtol=2e-4, atol=2e-5 * float(ref.abs().max()))
    assert torch.equal(got, sw.accumulate(vol, *args, **kw))
    ibar = torch.randn((3, Iu, Iv), generator=torch.Generator(cuda).manual_seed(4), device=cuda)
    g = sw.accumulate_adjoint(vol, *args, ibar, **kw)
    r = sw._accumulate_adjoint(vol, *args, ibar, bf16=False, **kw)
    torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-4 * float(r.abs().max()))
    assert torch.equal(g, sw.accumulate_adjoint(vol, *args, ibar, **kw))


@pytest.mark.parametrize("R,misaligned", [(500, False), (501, False), (501, True)])
def test_warp_kernels_match_plain(cuda, R, misaligned):
    """K2 and K3 against their float64 plain versions: R = 500 (the vector
    path), odd R (the scalar tail) and fields in views one float past an
    aligned buffer (the scalar path)."""
    from xvr_tpu_torch.render import shearwarp as sw

    g = torch.Generator(cuda).manual_seed(3)
    B, Iu, Iv = 3, 32, 48
    I = torch.rand((B, Iu, Iv), generator=g, device=cuda)

    def field(x):
        if not misaligned:
            return x
        buf = torch.empty(B * R + 1, device=cuda)
        buf[1:] = x.reshape(-1)
        return buf[1:].view(B, R)

    uc = field(torch.rand((B, R), generator=g, device=cuda) * (Iu + 3) - 2)
    vc = field(torch.rand((B, R), generator=g, device=cuda) * (Iv + 2) - 1.5)
    ws = field(torch.rand((B, R), generator=g, device=cuda) * 2.2 - 0.2)
    d = lambda *xs: [x.double() for x in xs]  # noqa: E731
    ref = sw._warp_plain(*d(I, uc, vc, ws), bf16=False)
    torch.testing.assert_close(sw.warp(I, uc, vc, ws).double(), ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
    for got, r in zip(sw.warp_with_grads(I, uc, vc, ws),
                      sw._warp_with_grads_plain(*d(I, uc, vc, ws), bf16=False)):
        torch.testing.assert_close(got.double(), r, rtol=0, atol=1e-5)


WARP_EDGE = ["odd R, misaligned view", "odd R", "Iv = 2"]


@pytest.mark.parametrize("case", WARP_EDGE)
def test_warp_kernels_edge_cases(cuda, case):
    """K2 and K3 on chip_smoke.py's edge cases (samples on the validity
    bounds and one ulp either side, ws = 0, odd R, a misaligned view,
    Iv = 2) against their float64 plain versions; two calls give identical
    bits."""
    from xvr_tpu_torch.render import shearwarp as sw

    smoke = _smoke()
    assert sorted(WARP_EDGE) == sorted(smoke.WARP_EDGE_CASES)
    I, uc, vc, ws = smoke.warp_edge_inputs(*smoke.WARP_EDGE_CASES[case], device=cuda)
    I64, w64 = I.double(), [a.double() for a in (uc, vc, ws)]
    ref = sw._warp_plain(I64, *w64, bf16=False)
    got = sw.warp(I, uc, vc, ws)
    torch.testing.assert_close(got.double(), ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
    assert torch.equal(got, sw.warp(I, uc, vc, ws))
    got = sw.warp_with_grads(I, uc, vc, ws)
    for a, r in zip(got, sw._warp_with_grads_plain(I64, *w64, bf16=False)):
        torch.testing.assert_close(a.double(), r, rtol=0, atol=1e-5 * float(I64.abs().max()))
    assert all(torch.equal(a, b) for a, b in zip(got, sw.warp_with_grads(I, uc, vc, ws)))


def test_warp_plans_give_identical_bits(cuda):
    """Every launch plan the kernels take (threads x pixels per thread) gives
    the bits of the plan that warp_plan picks, K3's outputs in one buffer or
    in three."""
    from xvr_tpu_torch.render import _cuda

    smoke = _smoke()
    lib = _cuda._load()
    for case in ("odd R", "Iv = 2"):
        B, Iu, Iv, R, _ = smoke.WARP_EDGE_CASES[case]
        I, uc, vc, ws = smoke.warp_edge_inputs(B, Iu, Iv, R, device=cuda)
        k2, k3 = _cuda.warp(I, uc, vc, ws), torch.stack(_cuda.warp_with_grads(I, uc, vc, ws))
        stream = torch.cuda.current_stream().cuda_stream
        for pix in (1, 2, 4):
            for threads in (64, 128, 256):
                out = torch.empty_like(k2)
                assert lib.sw_warp(I.data_ptr(), uc.data_ptr(), vc.data_ptr(), ws.data_ptr(),
                                   out.data_ptr(), B, Iu, Iv, R, threads, pix, stream) == 0
                outs = [torch.empty_like(k2) for _ in range(3)]
                assert lib.sw_warp_grads(I.data_ptr(), uc.data_ptr(), vc.data_ptr(), ws.data_ptr(),
                                         *(o.data_ptr() for o in outs), B, Iu, Iv, R, threads,
                                         pix, stream) == 0
                assert torch.equal(out, k2) and torch.equal(torch.stack(outs), k3), (threads, pix)
    bad = lib.sw_warp(I.data_ptr(), uc.data_ptr(), vc.data_ptr(), ws.data_ptr(), k2.data_ptr(),
                      B, Iu, Iv, R, 128, 3, stream)
    assert bad != 0  # three pixels per thread is refused


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
    assert all(v == int(k.startswith("sw_")) for k, v in _cuda.LAUNCHES.items()), _cuda.LAUNCHES
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


def _slab_inputs(dev, seed, B=3, R=300, M=24, Wd=20, L=28):
    """A (M, Wd, L) bf16 volume and (7, B, R) fields of rays that cross it
    within ~30 degrees of the march axis, some of them clipped by the box."""
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    vol = f(rng.uniform(0.0, 1.0, (M, Wd, L))).to(torch.bfloat16)
    s = np.stack([np.full((B, R), -30.0), rng.uniform(-4, Wd + 3, (B, R)),
                  rng.uniform(-4, L + 3, (B, R))])
    d = np.stack([np.full((B, R), M + 60.0), rng.uniform(-0.5, 0.5, (B, R)) * (M + 60),
                  rng.uniform(-0.5, 0.5, (B, R)) * (M + 60)])
    ws = rng.uniform(0.5, 2.0, (B, R))
    ws[:, :5] = 0.0  # padding rays
    return vol, f(np.concatenate([s, d, ws[None]])).contiguous()


def test_slab_forward_and_siddon_match_plain(cuda):
    from xvr_tpu_torch.render import pallas as sp

    vol, fields = _slab_inputs(cuda, 5)
    ref = sp._slab_forward(vol, fields.double())
    torch.testing.assert_close(sp.slab_forward(vol, fields).double(), ref, rtol=2e-4,
                               atol=2e-5 * float(ref.abs().max()))
    ref = sp._slab_siddon(vol, fields.double())
    torch.testing.assert_close(sp.slab_siddon(vol, fields).double(), ref, rtol=1e-3,
                               atol=1e-4 * float(ref.abs().max()))


def test_slab_backward_matches_plain(cuda):
    from xvr_tpu_torch.render import pallas as sp

    vol, fields = _slab_inputs(cuda, 6)
    g = torch.randn(fields.shape[1:], generator=torch.Generator(cuda).manual_seed(7), device=cuda)
    got = sp.slab_backward(vol, fields, g)
    ref = sp._slab_backward(vol, fields, g)
    for j in range(7):
        torch.testing.assert_close(got[j], ref[j], rtol=1e-3,
                                   atol=1e-4 * float(ref[j].abs().max()))


def _smoke():
    """chip_smoke.py, whose K5/K6 edge geometry (SLAB_EDGE_CASES) these tests share."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SLAB_EDGE = ["steep", "parallel", "source inside", "odd sizes", "trainer batch"]


@pytest.mark.parametrize("case", SLAB_EDGE)
def test_slab_kernels_edge_geometry(cuda, case):
    """K5 and K6 on rays along the planes, parallel to the window or lane
    axis, from a source inside the volume, with M = 19 and odd lanes, and at
    the trainer's batch of 116, with ws = 0 padding rays and ragged blocks;
    two calls give identical bits."""
    from xvr_tpu_torch.render import pallas as sp

    smoke = _smoke()
    assert sorted(SLAB_EDGE) == sorted(smoke.SLAB_EDGE_CASES)
    vol, fields = smoke.slab_edge_inputs(case, device=cuda)
    g = torch.randn(fields.shape[1:], generator=torch.Generator(cuda).manual_seed(8), device=cuda)
    got = sp.slab_forward(vol, fields)
    ref = sp._slab_forward(vol, fields.double())
    assert float(ref.abs().max()) > 0
    torch.testing.assert_close(got.double(), ref, rtol=2e-4, atol=2e-5 * float(ref.abs().max()))
    assert torch.equal(got, sp.slab_forward(vol, fields))
    got = sp.slab_backward(vol, fields, g)
    ref = sp._slab_backward(vol, fields, g)
    for j in range(7):
        torch.testing.assert_close(got[j], ref[j], rtol=1e-3,
                                   atol=1e-4 * float(ref[j].abs().max()))
    assert torch.equal(got, sp.slab_backward(vol, fields, g))


def test_slab_plane_split_is_the_models(cuda):
    """The kernels split a ray's planes as the CPU model of their plan does."""
    from test_torch_slab_plan import plane_split

    from xvr_tpu_torch.render import _cuda

    for B, R in ((16, 3600), (4, 239 * 239), (4, 120 * 120), (116, 1000), (64, 65536), (1, 7)):
        assert _cuda.slab_plane_split(B, R) == plane_split(B, R)


def test_slab_channels_match_plain(cuda):
    from xvr_tpu_torch.render import pallas as sp

    vol, fields = _slab_inputs(cuda, 8)
    labels = torch.as_tensor(np.random.default_rng(9).integers(0, 4, vol.shape), dtype=torch.uint8,
                             device=cuda)
    got = sp.slab_channels(vol, labels, (1, 3), fields)
    ref = sp._slab_channels(vol, labels, (1, 3), fields)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
    k5 = sp.slab_forward(vol, fields)
    torch.testing.assert_close(got.sum(1), k5, rtol=1e-5, atol=1e-5 * float(k5.abs().max()))


def test_slab_render_launches_its_kernels(cuda):
    """A slab render and its backward go through K5 and K6; a labelmap
    render through K7; a Siddon render through K8; and only there."""
    from xvr_tpu_torch.geometry import Detector, convert
    from xvr_tpu_torch.render import _cuda
    from xvr_tpu_torch.render.pallas import raymarch_siddon_pallas, raymarch_trilinear_pallas

    n = 40
    g = torch.Generator(cuda).manual_seed(4)
    density = torch.rand((n, n, n), generator=g, device=cuda)
    mask = (density > 0.5).to(torch.int32)
    affinv = torch.eye(4, device=cuda) / 2.0
    affinv[3, 3] = 1.0
    affinv[:3, 3] = (n - 1) / 2.0
    rot = torch.tensor([[180.0, 2.0, -3.0], [178.0, -1.0, 2.0]], device=cuda, requires_grad=True)
    xyz = torch.tensor([[0.0, 500.0, 0.0], [3.0, 520.0, -2.0]], device=cuda)
    det = Detector(sdd=1000.0, height=32, width=32, delx=3.0, dely=3.0)
    _cuda.reset_launches()
    src, tgt = det.rays(convert(rot, xyz, "euler_angles", "ZXY", degrees=True))
    img = raymarch_trilinear_pallas(density, affinv, src, tgt)
    ch = raymarch_trilinear_pallas(density, affinv, src, tgt, mask=mask, labels=(1,))
    ((img**2).sum() + ch.sum()).backward()
    with torch.no_grad():
        sid = raymarch_siddon_pallas(density, affinv, src, tgt)
    torch.cuda.synchronize()
    want = dict.fromkeys(_cuda.LAUNCHES, 0)
    want.update(slab_forward=1, slab_backward=2, slab_channels=1, slab_siddon=1)
    assert _cuda.LAUNCHES == want
    assert torch.isfinite(img).all() and torch.isfinite(sid).all()
    assert float(rot.grad.abs().sum()) > 0


def test_fast_render_slab_backward_launches_k6(cuda):
    """backward="slab" pairs the shear-warp forward (K1, K2) with K6."""
    from xvr_tpu_torch.geometry import Detector, convert
    from xvr_tpu_torch.render import _cuda, raymarch_trilinear_fast

    n = 40
    density = torch.rand((n, n, n), generator=torch.Generator(cuda).manual_seed(5), device=cuda)
    affinv = torch.eye(4, device=cuda) / 2.0
    affinv[3, 3] = 1.0
    affinv[:3, 3] = (n - 1) / 2.0
    rot = torch.tensor([[180.0, 2.0, -3.0]], device=cuda, requires_grad=True)
    xyz = torch.tensor([[0.0, 500.0, 0.0]], device=cuda)
    det = Detector(sdd=1000.0, height=32, width=32, delx=3.0, dely=3.0)
    _cuda.reset_launches()
    src, tgt = det.rays(convert(rot, xyz, "euler_angles", "ZXY", degrees=True))
    (raymarch_trilinear_fast(density, affinv, src, tgt, backward="slab") ** 2).sum().backward()
    torch.cuda.synchronize()
    want = dict.fromkeys(_cuda.LAUNCHES, 0)
    want.update(sw_accumulate=1, sw_warp=1, slab_backward=1)
    assert _cuda.LAUNCHES == want
    assert float(rot.grad.abs().sum()) > 0


@pytest.mark.parametrize("case", SLAB_EDGE)
def test_channel_and_siddon_kernels_edge_geometry(cuda, case):
    """K7 and K8 on chip_smoke.py's K5/K6 edge geometry, with labels 0-3 and
    255 and channels (1, 2, 255): K7 against its float32 plain version and
    its channel sum against the float64 K5, K8 against its float64 plain
    version; two calls give identical bits."""
    from xvr_tpu_torch.render import pallas as sp

    smoke = _smoke()
    vol, fields = smoke.slab_edge_inputs(case, device=cuda)
    lab = smoke.slab_edge_labels(vol.shape, device=cuda)
    chans = smoke.EDGE_CHANS
    got = sp.slab_channels(vol, lab, chans, fields)
    ref = sp._slab_channels(vol, lab, chans, fields)
    assert float(ref.abs().max()) > 0
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5 * float(ref.abs().max()))
    r5 = sp._slab_forward(vol, fields.double())
    torch.testing.assert_close(got.sum(1).double(), r5, rtol=2e-4,
                               atol=2e-5 * float(r5.abs().max()))
    assert torch.equal(got, sp.slab_channels(vol, lab, chans, fields))
    got = sp.slab_siddon(vol, fields)
    ref = sp._slab_siddon(vol, fields.double())
    torch.testing.assert_close(got.double(), ref, rtol=1e-3, atol=1e-4 * float(ref.abs().max()))
    assert torch.equal(got, sp.slab_siddon(vol, fields))


@pytest.mark.parametrize("B,R,split", [(1, 100, 8), (70, 1000, 4), (140, 1000, 2),
                                       (270, 1000, 1)])
def test_channel_and_siddon_kernels_every_split(cuda, B, R, split):
    """K7 and K8 with each plane split the rule picks (M = 19: ranges no
    multiple of the split), against their plain versions."""
    from xvr_tpu_torch.render import _cuda
    from xvr_tpu_torch.render import pallas as sp

    smoke = _smoke()
    assert _cuda.slab_plane_split(B, R) == split
    vol, fields = smoke.slab_edge_inputs("odd sizes", device=cuda, B=B, R=R)
    lab = smoke.slab_edge_labels(vol.shape, device=cuda)
    got = sp.slab_channels(vol, lab, (1, 2), fields)
    ref = sp._slab_channels(vol, lab, (1, 2), fields)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5 * float(ref.abs().max()))
    got = sp.slab_siddon(vol, fields)
    ref = sp._slab_siddon(vol, fields.double())
    torch.testing.assert_close(got.double(), ref, rtol=1e-3, atol=1e-4 * float(ref.abs().max()))


@pytest.mark.parametrize("chans", [(), (1, 1, 255), (3, 2, 1, 0), tuple(range(1, 16))])
def test_slab_channels_channel_lists(cuda, chans):
    """No channel, a duplicate value (two channels take the same samples),
    label 0 named, and the kernel's 16 channels (sums in shared memory)."""
    from xvr_tpu_torch.render import pallas as sp

    smoke = _smoke()
    vol, fields = smoke.slab_edge_inputs("trainer batch", device=cuda, B=4)
    lab = torch.as_tensor(np.random.default_rng(10).integers(0, 256, vol.shape),
                          dtype=torch.uint8, device=cuda)
    got = sp.slab_channels(vol, lab, chans, fields)
    ref = sp._slab_channels(vol, lab, chans, fields)
    assert got.shape == (4, len(chans) + 1, fields.shape[2])
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5 * float(ref.abs().max()))
    assert torch.equal(got, sp.slab_channels(vol, lab, chans, fields))
    with pytest.raises(ValueError, match="channels"):
        sp.slab_channels(vol, lab, tuple(range(16)), fields)


def test_slab_channels_copies_nothing_to_the_device(cuda):
    """The channel values go to K7 by value: a call makes no host-to-device
    copy (none under torch.profiler), so it can be captured in a graph."""
    from torch.profiler import ProfilerActivity, profile

    from xvr_tpu_torch.render import pallas as sp

    smoke = _smoke()
    vol, fields = smoke.slab_edge_inputs("odd sizes", device=cuda)
    lab = smoke.slab_edge_labels(vol.shape, device=cuda)
    sp.slab_channels(vol, lab, (1, 2), fields)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            sp.slab_channels(vol, lab, (1, 2), fields)
        torch.cuda.synchronize()
    keys = [ev.key for ev in prof.key_averages()]
    assert any("slab_channels_kernel" in k for k in keys), keys
    assert not any("HtoD" in k for k in keys), keys
