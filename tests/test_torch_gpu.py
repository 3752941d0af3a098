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
    got = sw.accumulate(vol, *args, boxes=sw.content_boxes(vol)[0], **kw).double()
    ref = sw._accumulate(vol, *[a.double() for a in args], bf16=False, **kw)
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("eps,k0,k1,sgnval", CASES)
def test_adjoint_kernel_matches_plain(cuda, eps, k0, k1, sgnval):
    from xvr_tpu_torch.render import shearwarp as sw

    vol, args, (Iu, Iv) = _inputs(cuda, 1, sgnval)
    ibar = torch.randn((5, Iu, Iv), generator=torch.Generator(cuda).manual_seed(2), device=cuda)
    kw = dict(Iu=Iu, Iv=Iv, eps=eps, k0=k0, k1=k1)
    boxes = sw.content_boxes(vol)[0]
    got = sw.accumulate_adjoint(vol, *args, ibar, boxes=boxes, **kw)
    ref = sw._accumulate_adjoint(vol, *args, ibar, bf16=False, **kw)
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-4 * float(ref.abs().max()))
    assert torch.equal(got, sw.accumulate_adjoint(vol, *args, ibar, boxes=boxes, **kw))


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
    boxes = sw.content_boxes(vol)[0]
    got = sw.accumulate(vol, *args, boxes=boxes, **kw)
    ref = sw._accumulate(vol, *[a.double() for a in args], bf16=False, **kw)
    assert float(ref.abs().max()) > 0
    torch.testing.assert_close(got.double(), ref, rtol=2e-4, atol=2e-5 * float(ref.abs().max()))
    assert torch.equal(got, sw.accumulate(vol, *args, boxes=boxes, **kw))
    ibar = torch.randn((3, Iu, Iv), generator=torch.Generator(cuda).manual_seed(4), device=cuda)
    g = sw.accumulate_adjoint(vol, *args, ibar, boxes=boxes, **kw)
    r = sw._accumulate_adjoint(vol, *args, ibar, bf16=False, **kw)
    torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-4 * float(r.abs().max()))
    assert torch.equal(g, sw.accumulate_adjoint(vol, *args, ibar, boxes=boxes, **kw))


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
    """A fast render and its backward go through K1-K4, and the pose
    gradient of the rays through ``rays_adjoint``, and only there."""
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
    assert all(v == int(k.startswith("sw_") or k == "rays_adjoint")
               for k, v in _cuda.LAUNCHES.items()), _cuda.LAUNCHES
    assert torch.isfinite(img).all() and torch.isfinite(rot.grad).all()
    assert float(rot.grad.abs().sum()) > 0


def test_wrappers_check_their_inputs(cuda):
    from xvr_tpu_torch.render import _cuda

    vol = torch.zeros((4, 5, 6), device=cuda)  # float32, not bf16
    boxes = torch.zeros((4, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        _cuda.accumulate(vol, torch.zeros((2, 8), device=cuda), boxes, Iu=8, Iv=8, eps=1.0, k0=0,
                         k1=4)
    with pytest.raises(ValueError, match="slab bounds"):
        _cuda.accumulate(vol.bfloat16(), torch.zeros((2, 8), device=cuda), boxes, Iu=8, Iv=8,
                         eps=1.0, k0=0, k1=9)
    with pytest.raises(ValueError, match="boxes has shape"):
        _cuda.accumulate(vol.bfloat16(), torch.zeros((2, 8), device=cuda), boxes[:3], Iu=8, Iv=8,
                         eps=1.0, k0=0, k1=4)


# ---------------------------------------------------------------------------
# K1/K4's content skip: with the volume's content boxes each kernel equals
# itself given boxes that every tile meets (no content skip), bit for bit,
# and the slab tally's counts of the two add up.
# ---------------------------------------------------------------------------


def _whole(vol):
    M, Wd, L = vol.shape
    return torch.tensor([0, Wd - 1, 0, L - 1], dtype=torch.int32, device=vol.device).repeat(M, 1)


def _tallied(call):
    """-> (``call()``, the (marched, skipped) slabs it added to the tally)."""
    from xvr_tpu_torch.render import _cuda

    tally = _cuda.slab_tally(torch.device("cuda"))
    before = tally.clone()
    out = call()
    return out, tuple((tally - before).tolist())


def _skip_is_exact(vol, args, Iu, Iv, eps, ibar, k0=0, k1=None):
    """K1 and K4 with ``vol``'s content boxes against whole-slab boxes ->
    (K1's image, K1's (marched, skipped), K4's (marched, skipped))."""
    from xvr_tpu_torch.render import _cuda
    from xvr_tpu_torch.render import shearwarp as sw

    boxes = sw.content_boxes(vol)[0]
    assert torch.equal(boxes.cpu(), sw._content_boxes(vol.cpu())[0])
    params = sw._params(*args)
    kw = dict(eps=eps, k0=k0, k1=vol.shape[0] if k1 is None else k1)
    ib = ibar.to(torch.bfloat16).contiguous()
    calls = (lambda b: (_cuda.accumulate(vol, params, b, Iu=Iu, Iv=Iv, **kw),),
             lambda b: _cuda.accumulate_adjoint(vol, params, ib, b, **kw))
    out, counts = None, []
    for call in calls:
        got, (m, k) = _tallied(lambda: call(boxes))
        dense, (md, kd) = _tallied(lambda: call(_whole(vol)))
        assert all(torch.equal(a, b) for a, b in zip(got, dense))
        assert kd == 0 and m + k == md, ((m, k), (md, kd))
        out = got[0] if out is None else out
        counts.append((m, k))
    return out, counts[0], counts[1]


def _body(dev, seed, M, Wd, L, pad=(0, 0, 0)):
    """A (M, Wd, L) bf16 volume: an ellipsoid of random density in air, then
    ``pad`` zero slabs, rows and lanes on each side."""
    rng = np.random.default_rng(seed)
    g = [np.linspace(-1.0, 1.0, n) for n in (M, Wd, L)]
    X, Y, Z = np.meshgrid(*g, indexing="ij")
    inside = (X / 0.7) ** 2 + (Y / 0.6) ** 2 + (Z / 0.65) ** 2 <= 1.0
    vol = np.where(inside, rng.uniform(0.1, 1.0, inside.shape), 0.0)
    vol = np.pad(vol, [(p, p) for p in pad])
    return torch.as_tensor(vol.astype(np.float32), device=dev).to(torch.bfloat16)


def _body_args(dev, vol, B=4, seed=5):
    """Rays from before slab 0 (w_k = 1 on every slab) through the volume's
    middle, slopes spanning about 0.8 of it -> (args, Iu, Iv)."""
    M, Wd, L = vol.shape
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    c = M + 8.0
    s_p = np.array([-8.0, Wd / 2, L / 2]) + rng.normal(0.0, 0.5, (B, 3))
    du, dv = 0.9 * Wd / c / 48, 0.9 * L / c / 128
    args = (f(s_p), f(np.ones(B)), f(np.full(B, -24 * du)), f(np.full(B, du)),
            f(np.full(B, -64 * dv)), f(np.full(B, dv)))
    return args, 48, 128


def _ibar(dev, B, Iu, Iv, seed=2):
    return torch.randn((B, Iu, Iv), generator=torch.Generator(dev).manual_seed(seed), device=dev)


@pytest.mark.parametrize("eps", [1.0, 0.25])
def test_content_skip_body_in_air(cuda, eps):
    vol = _body(cuda, 0, 40, 36, 48)
    args, Iu, Iv = _body_args(cuda, vol)
    img, (m1, k1), (m4, k4) = _skip_is_exact(vol, args, Iu, Iv, eps, _ibar(cuda, 4, Iu, Iv))
    assert float(img.abs().max()) > 0 and k1 > 0 and k4 > 0 and m1 > 0


@pytest.mark.parametrize("pad", [(6, 0, 0), (0, 5, 7), (3, 4, 9)], ids=["march", "across", "both"])
def test_content_skip_padded_volume(cuda, pad):
    """A volume padded with zeros along the march axis, across it, or both,
    as the foundation trainer pads its subjects."""
    vol = _body(cuda, 1, 30, 28, 40, pad=pad)
    args, Iu, Iv = _body_args(cuda, vol)
    img, (m1, k1), _ = _skip_is_exact(vol, args, Iu, Iv, 1.0, _ibar(cuda, 4, Iu, Iv))
    assert float(img.abs().max()) > 0 and k1 > 0


def test_content_skip_label_stack(cuda):
    """The trainer's 8-channel stack (the density, then one masked copy per
    label) over each channel's slab range; a label absent from the mask
    gives a channel of exact zeros whose every slab is skipped."""
    from xvr_tpu_torch.render import shearwarp as sw

    vol = _body(cuda, 2, 40, 36, 48).float()
    M, Wd, L = vol.shape
    mask = torch.zeros((M, Wd, L), dtype=torch.int32, device=cuda)
    for i, lab in enumerate((1, 2, 3, 4, 5, 7)):
        mask[6 + 4 * i : 10 + 4 * i, 8 + 3 * i : 16 + 2 * i, 10 : 20 + 4 * i] = lab
    labels = (1, 2, 3, 4, 5, 7, 9)  # 9: absent
    stack = sw.prepare_shearwarp(vol, (0, 1, 2), mask=mask, labels=labels)
    bounds = sw.channel_slab_bounds(mask, labels, (0, 1, 2))
    args, Iu, Iv = _body_args(cuda, stack[0])
    ibar = _ibar(cuda, 4, Iu, Iv)
    for c in range(stack.shape[0]):
        img, (m1, k1), (m4, k4) = _skip_is_exact(stack[c], args, Iu, Iv, 1.0, ibar, *bounds[c])
        assert k1 > 0 and k4 > 0, c
        if c == len(labels):
            assert m1 == m4 == 0 and not bool(img.any())
        else:
            assert float(img.abs().max()) > 0


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_content_skip_steep_and_edge(cuda, case):
    """EDGE_CASES' geometry (steep rows, wide lanes, an odd L at the edges,
    a box read from global memory) on their volumes with zero slabs, rows
    and lanes."""
    vol, args, (Iu, Iv) = _edge_inputs(cuda, 3, **EDGE_CASES[case])
    M, Wd, L = vol.shape
    vol[M // 2 :] = 0.0
    vol[:, Wd // 3 : Wd // 2] = 0.0
    vol[:, :, L // 3 : L // 2] = -0.0
    for eps in (1.0, 0.25):
        _, (_, k1), _ = _skip_is_exact(vol, args, Iu, Iv, eps, _ibar(cuda, 3, Iu, Iv, seed=4))
        assert k1 > 0


@pytest.mark.parametrize("case", ["coarse B=16", "fine B=4", "trainer B=116"])
def test_content_skip_at_the_path_shapes(cuda, case):
    """The registration's coarse and fine shapes (the bench scene's 1336^2
    crop projector, masked to its bone) and the trainer's 116 poses at 128^2
    over its label stack, from chip_smoke.py's phantom at 128^3; the
    trainer's forward render through its operand against the same stack
    with whole-slab boxes, bit for bit."""
    from xvr_tpu_torch.render import shearwarp as sw

    smoke = _smoke()
    hu, aff, _ = smoke.build_phantom(128)
    if case.startswith("trainer"):
        proj, pose = smoke.sw_trainer_inputs(hu, aff)
        stack, bounds = proj.prepare_for_shearwarp(), proj.shearwarp_bounds
        x = smoke.path_inputs(proj, pose, seed=3)
        op = proj.prepare()
        dense = sw.ShearWarpOperand(op.vol, torch.stack([_whole(v) for v in op.vol]))
        src, tgt = proj.rays(pose)
        a, (m, k) = _tallied(lambda: proj.render_rays(src, tgt, prepared=op))
        b, (md, kd) = _tallied(lambda: proj.render_rays(src, tgt, prepared=dense))
        assert torch.equal(a, b) and k > 0 and kd == 0 and m + k == md
    else:
        _, proj, pose16, pose4 = smoke.bench_projector(np.where(hu > 600.0, hu, -1000.0), aff)
        fast = proj.with_shearwarp(pose16[:1])
        label, pose, scale = next(c for c in smoke.stage_cases(fast, pose16, pose4)
                                  if c[0] == case)
        proj = fast.rescale_detector(scale)
        stack, bounds = proj.prepare_for_shearwarp()[None], ((0, None),)
        x = smoke.path_inputs(proj, pose, seed=1)
    Iu, Iv = x["grid"]
    args = (x["s"], x["sgn"], x["u0"], x["du"], x["v0"], x["dv"])
    ibar = sw._warp_transpose(x["g"] * x["ws"], x["uc"], x["vc"], grid_shape=(Iu, Iv))
    skipped = 0
    for c in range(stack.shape[0]):
        _, (_, k1), (_, k4) = _skip_is_exact(stack[c], args, Iu, Iv, 1.0, ibar, *bounds[c])
        skipped += k1 + k4
    assert skipped > 0


@pytest.mark.parametrize("L,misaligned", [(48, False), (37, False), (48, True)])
def test_content_boxes_kernel_matches_plain(cuda, L, misaligned):
    """The box kernel by 16-byte loads (L % 8 == 0, aligned) and by bf16
    loads (an odd L, or a volume 2 bytes off), on a stack with empty slabs,
    an empty channel, single voxels on the faces and -0.0."""
    from xvr_tpu_torch.render import shearwarp as sw

    C, M, Wd = 3, 10, 20
    rng = np.random.default_rng(9)
    vol = rng.uniform(0.1, 1.0, (C, M, Wd, L)) * (rng.uniform(size=(C, M, Wd, L)) < 0.05)
    vol[0, 3] = -0.0
    vol[1] = 0.0
    vol[2, 4] = 0.0
    vol[2, 4, 0, L - 1] = vol[2, 4, Wd - 1, 0] = 0.5
    host = torch.as_tensor(vol.astype(np.float32)).to(torch.bfloat16)
    flat = torch.zeros(host.numel() + 8, dtype=torch.bfloat16, device=cuda)
    dev = flat[1 : 1 + host.numel()] if misaligned else flat[: host.numel()]
    dev = dev.view(C, M, Wd, L)
    dev.copy_(host)
    assert torch.equal(sw.content_boxes(dev).cpu(), sw._content_boxes(host))
    assert torch.equal(sw.content_boxes(dev[2]).cpu(), sw._content_boxes(host[2]))


def test_slab_tally_counts_graph_replays(cuda):
    """The tally sits at one address: a CUDA graph that captured K1 and K4
    adds their counts at every replay; ``profiling`` reads it as the
    counters ``shearwarp.slabs_marched`` and ``.slabs_skipped`` and zeroes it
    at ``reset``."""
    from xvr_tpu_torch.render import _cuda
    from xvr_tpu_torch.render import shearwarp as sw
    from xvr_tpu_torch.utils import profiling

    vol = _body(cuda, 4, 40, 36, 48)
    args, Iu, Iv = _body_args(cuda, vol)
    params, boxes = sw._params(*args), sw.content_boxes(vol)[0]
    ibar = _ibar(cuda, 4, Iu, Iv).to(torch.bfloat16)
    M = vol.shape[0]

    def step():
        I = _cuda.accumulate(vol, params, boxes, Iu=Iu, Iv=Iv, eps=1.0, k0=0, k1=M)
        return I, _cuda.accumulate_adjoint(vol, params, ibar, boxes, eps=1.0, k0=0, k1=M)

    (I0, _), once = _tallied(step)
    assert once[1] > 0
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        I, _ = step()
    _, twice = _tallied(lambda: (graph.replay(), graph.replay()))
    torch.cuda.synchronize()
    assert twice == (2 * once[0], 2 * once[1]) and torch.equal(I, I0)
    profiling.reset()
    _, counted = _tallied(step)
    snap = profiling.snapshot()["counters"]
    assert (snap["shearwarp.slabs_marched"], snap["shearwarp.slabs_skipped"]) == counted == once


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
    want.update(slab_forward=1, slab_backward=2, slab_channels=1, slab_siddon=1, rays_adjoint=1)
    assert _cuda.LAUNCHES == want
    assert torch.isfinite(img).all() and torch.isfinite(sid).all()
    assert float(rot.grad.abs().sum()) > 0


def test_fast_render_slab_backward_launches_k6(cuda):
    """backward="slab" pairs the shear-warp forward (K1, K2, and the
    content boxes of the volume it prepares) with K6."""
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
    want.update(sw_accumulate=1, sw_warp=1, slab_backward=1, rays_adjoint=1, sw_content_boxes=1)
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


def test_resnet34_forward_matches_cpu(cuda):
    """The pose CNN users run (ResNet-34, GroupNorm) at 128^2 on the card
    against the same module on the CPU: within chip_smoke.py's 1e-2 of max
    |feature| with cuDNN's TF32 convolutions as PyTorch sets them, 1e-4 with
    TF32 off."""
    from xvr_tpu_torch.models import PoseRegressor, init_pose_regressor

    smoke = _smoke()
    model = init_pose_regressor(PoseRegressor("resnet34"), torch.Generator().manual_seed(0)).eval()
    x = torch.as_tensor(np.random.default_rng(11).normal(size=(2, 1, 128, 128)), dtype=torch.float32)
    with torch.no_grad():
        ref = model.backbone(x)
        card = model.to(cuda)
        got = card.backbone(x.to(cuda)).cpu()
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            got32 = card.backbone(x.to(cuda)).cpu()
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= smoke.CNN_TF32_RTOL * scale
    assert float((got32 - ref).abs().max()) <= smoke.CNN_FP32_RTOL * scale


def test_register_entry_points_on_the_card(cuda, tmp_path):
    """chip_smoke.py's phase 5 on a 64^3 phantom and a 356^2 X-ray: ``register
    model`` from a ResNet-34 checkpoint launches K1-K4 and the rays' pose
    adjoint and no other kernel, and ends under 1 mm; ``register restart`` and ``register dicom`` start
    from the bundle's and the positioner's poses."""
    smoke = _smoke()
    hu, aff, fids = smoke.build_phantom(64)
    gt_pose, _, _ = smoke.write_scene(tmp_path, hu, aff, dev="cuda", det=356)
    launches, stats = smoke.phase_entry_points(
        tmp_path, gt_pose, fids, "card", dev="cuda",
        register_args=["--scales", "6,3", "--n_itrs", "100,100", "--coarse_seeds", "6",
                       "--restart_seeds", "2", "--verbose", "0"],
        restart_args=["--scales", "3", "--n_itrs", "20", "--restart_seeds", "2",
                      "--max_restarts", "0", "--verbose", "0"])
    assert all(launches[k] > 0 for k in smoke.SW_KERNELS)
    assert stats["model"]["mtre_final_mm"] < 1.0 and stats["cnn"]["forward_ms"] > 0


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _train_scene(tmp_path, n=64):
    """chip_smoke.py's phantom at n^3 with the trainer's two-label mask, as
    NIfTI files."""
    from xvr_tpu_torch.io import save_nifti

    smoke = _smoke()
    hu, aff, _ = smoke.build_phantom(n)
    save_nifti(tmp_path / "ct.nii.gz", hu, aff)
    save_nifti(tmp_path / "mask.nii.gz", smoke.train_mask(n).astype(np.float32), aff)
    return tmp_path / "ct.nii.gz", tmp_path / "mask.nii.gz"


def _small_trainer(ct, mask, out, device, **kw):
    from xvr_tpu_torch.train import Trainer

    smoke = _smoke()
    cfg = dict(volpath=ct, maskpath=mask, outpath=out, sdd=1020.0, height=64, delx=4.0,
               model_name="resnet18", batch_size=4, n_total_itrs=4, n_warmup_itrs=1,
               n_grad_accum_itrs=1, n_save_every_itrs=100, lr=1e-3, p_augmentation=0.0)
    cfg.update({**smoke.FINETUNE_RANGES, **kw})
    return Trainer(**cfg, device=device)


@pytest.mark.parametrize("masked", [False, True])
def test_trainer_slab_fallback_on_the_card(cuda, tmp_path, monkeypatch, masked):
    """The slab route (every shear-warp stratum declined by hand: on one
    subject no ranges make them all decline while the slab gate accepts): a step
    launches K5 twice and K6 once unmasked, K7 twice and K6 once masked, and
    trains finitely."""
    from xvr_tpu_torch.render import _cuda
    from xvr_tpu_torch.train import Trainer

    monkeypatch.setattr(Trainer, "_try_shearwarp_strata", lambda self, edges: False)
    ct, mask = _train_scene(tmp_path)
    # the slab gate (rays within 45 degrees of the march axis) declines the
    # finetune ranges; these narrower ones pass it
    narrow = dict(alphamin=170.0, alphamax=190.0, betamin=-10.0, betamax=10.0,
                  gammamin=-5.0, gammamax=5.0)
    tr = _small_trainer(ct, mask if masked else None, tmp_path / "out", "cuda", **narrow)
    route = tr.route()
    assert route["renderer"] == "trilinear_pallas"
    expect = _smoke().route_launches(route)
    assert expect == ({"slab_channels": 2, "slab_backward": 1, "rays_adjoint": 1} if masked
                      else {"slab_forward": 2, "slab_backward": 1, "rays_adjoint": 1})
    for itr in range(2):
        _cuda.reset_launches()
        m = tr.step(itr)
        torch.cuda.synchronize()
        assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == expect
        assert all(np.isfinite(float(v)) for v in m.values())


@pytest.mark.parametrize("masked", [False, True])
def test_trainer_step_on_the_card_matches_cpu(cuda, tmp_path, monkeypatch, masked):
    """One shear-warp training step on the card (K1-K4, TF32 off) against
    the same step on the CPU (the plain versions) at equal weights and
    draws: loss and metrics to rtol 2e-2 (the kernels compute in float32
    from the bf16 table, the CPU path rounds its partial products to bf16
    as the JAX package does; mncc also to 2e-2 absolute), and the gradient
    to cosine 0.99 over the parameter tree."""
    monkeypatch.setenv("XVR_FORCE_SHEARWARP", "1")
    ct, mask = _train_scene(tmp_path)
    m = mask if masked else None
    card = _small_trainer(ct, m, tmp_path / "card", "cuda")
    cpu = _small_trainer(ct, m, tmp_path / "cpu", "cpu")
    assert card.route() == cpu.route() and card.route()["renderer"] == "trilinear_fast"
    cpu.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
    draws = cpu.draw(torch.Generator().manual_seed(5))
    moved = {"pose": draws["pose"].to(cuda), "contrast": draws["contrast"].to(cuda),
             "aug": {k: v.to(cuda) for k, v in draws["aug"].items()}}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        lc, mc, gc = card.loss_and_grads(card.projectors[0], card.centers[0], moved)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    lr, mr, gr = cpu.loss_and_grads(cpu.projectors[0], cpu.centers[0], draws)
    assert abs(float(lc) - float(lr)) <= 2e-2 * abs(float(lr))
    for k in mr:
        atol = 2e-2 if k == "mncc" else 1e-6
        assert abs(float(mc[k]) - float(mr[k])) <= atol + 2e-2 * abs(float(mr[k])), k
    a = torch.cat([gc[k].cpu().ravel() for k in gr]).double()
    b = torch.cat([gr[k].ravel() for k in gr]).double()
    assert float(a @ b / (a.norm() * b.norm())) >= 0.99


@pytest.mark.parametrize("B,height", [(4, 32), (1, 34)])
def test_ray_sharded_fast_render_is_bit_identical(cuda, B, height):
    """The ray-sharded shear-warp render on a 4-slot mesh of the one card
    (dp 2, rays 2): B=4 splits the batch over dp and the rows over rays, B=1
    the rows over all 4 slots (34 rows pad to 36). Under the full detector's
    grid bounds K1 sees identical inputs and K2 works per pixel, so the
    forward equals the unsharded render bit for bit, with one K1 and one K2
    launch per block; the pose gradient (K3, K4 per block) is held to the
    JAX test's tolerance."""
    from xvr_tpu_torch.geometry import RigidTransform, convert
    from xvr_tpu_torch.parallel import make_mesh, ray_sharded_fast_render
    from xvr_tpu_torch.render import Projector, _cuda, make_test_volume

    vol = make_test_volume(48, spacing=2.0, kind="sphere", device=cuda)
    proj = Projector.from_volume(vol, sdd=400.0, height=height, delx=4.0)
    rot = torch.tensor([[180.0, 5.0, -3.0], [170.0, -5.0, 3.0], [185.0, 2.0, 1.0],
                        [175.0, -2.0, -1.0]], device=cuda)[:B]
    xyz = torch.tensor([[0.0, 200.0, 0.0], [5.0, 220.0, -5.0], [-3.0, 210.0, 2.0],
                        [2.0, 205.0, -2.0]], device=cuda)[:B]
    pose = convert(rot, xyz, "euler_angles", "ZXY", degrees=True)
    fast = proj.with_shearwarp(pose)
    assert fast.renderer == "trilinear_fast"
    prep = fast.prepare()
    mesh = make_mesh(4, rays=2, devices=[cuda] * 4)
    ref = fast.render_rays(*fast.rays(pose), prepared=prep)
    _cuda.reset_launches()
    out = ray_sharded_fast_render(mesh, fast, pose, prepared=prep)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {"sw_accumulate": 4, "sw_warp": 4}

    def grad(render):
        m = pose.matrix.clone().requires_grad_(True)
        (g,) = torch.autograd.grad((render(RigidTransform(m)) ** 2).sum(), m)
        return g.double().ravel()

    a = grad(lambda p: ray_sharded_fast_render(mesh, fast, p, prepared=prep))
    b = grad(lambda p: fast.render_rays(*fast.rays(p), prepared=prep))
    torch.testing.assert_close(a, b, rtol=2e-2, atol=1e-4 * float(b.abs().max()))
    assert float(a @ b / (a.norm() * b.norm())) > 1.0 - 1e-6


def test_mesh_training_step_on_the_card_matches_unsharded(cuda, tmp_path, monkeypatch):
    """A masked shear-warp training step on a 2-slot mesh of the one card
    against the mesh-free step at equal weights and draws (cuDNN's TF32 off):
    the loss to rtol 1e-4; K1-K4 launch once per slot for each of their
    renders."""
    from xvr_tpu_torch.parallel import make_mesh
    from xvr_tpu_torch.render import _cuda

    monkeypatch.setenv("XVR_FORCE_SHEARWARP", "1")
    ct, mask = _train_scene(tmp_path)
    ref = _small_trainer(ct, mask, tmp_path / "ref", cuda)
    tr = _small_trainer(ct, mask, tmp_path / "mesh", cuda, mesh=make_mesh(2, devices=[cuda] * 2))
    tr.model.load_state_dict(ref.model.state_dict())
    draws = ref.draw()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the CNN's chunks then differ only in sum order
    try:
        lr, _, _ = ref.loss_and_grads(ref.projectors[0], ref.centers[0], draws)
        _cuda.reset_launches()
        lm, _, _ = tr.loss_and_grads(tr.projectors[0], tr.centers[0], draws)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert abs(float(lm) - float(lr)) <= 1e-4 * abs(float(lr))
    C = 1 + len(tr.labels)
    assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {
        "sw_accumulate": 2 * 2 * C, "sw_warp": 2 * 2, "sw_warp_grads": 2,
        "sw_accumulate_adjoint": 2 * C, "rays_adjoint": 2, "sw_content_boxes": 1}


# ---------------------------------------------------------------------------
# the dataset workflows
# ---------------------------------------------------------------------------

TRAJECTORY_ATOL = 1e-3  # tests/test_torch_registrar.py's
# rows held to it: the pose parameters of the init and the first two steps,
# the NCC of the first ten. Adam amplifies float32 round-off, so the card's
# rows 3-5 stand 1.0e-3, 1.5e-3 and 1.3e-2 mm from the CPU's (the CPU with
# bf16=True stands as far from the CPU with bf16=False), while the NCCs of
# rows 0-9 stay within 1.4e-4 (H100, the calls of this test's scene)
POSE_ROWS, NCC_ROWS = 3, 10
# the first iteration's pose gradient (rotation and translation parameters,
# each relative to its largest component). Through K1-K4 against the plain
# versions on the same card, whose inputs are then the same bits: the
# kernels' arithmetic alone (H100: 2.3e-5 and 1.0e-6). Card against CPU:
# the inputs differ in their last bits, and on this 15^2 stage the rotation
# gradient jumps where a sample crosses a warp cell (H100 against CPU:
# 4.5e-3 and 4.7e-5)
GRAD_RTOL_SAME_INPUTS = 1e-4
GRAD_RTOL_CPU = {"rotation": 5e-2, "translation": 1e-3}


def test_masked_linearized_register_model_matches_the_cpu(cuda, tmp_path, monkeypatch):
    """chip_smoke.py's DeepFluoro subject at 64^3 and 356^2, its air filled
    with graded soft tissue as tests/test_torch_registrar.py's phantom is (on
    a flat background the local NCC and its gradient are float32 rounding
    noise, which differs between any two implementations): ``register
    model`` with the mask, ``--labels 1,2,3,4,7`` and
    ``--linearize`` (one start, no re-anneal) through K1-K4 on the card,
    the same call on the card with the kernels' wrappers swapped for the
    plain versions, and the same call with ``--device cpu`` (the plain
    versions with the kernels' arithmetic, ``bf16=False``; their default
    JAX bf16 recipe moves the gradient by 0.3-0.6%). The first iteration's
    pose gradient agrees with the plain run on the card within
    GRAD_RTOL_SAME_INPUTS and with the CPU's within GRAD_RTOL_CPU; the first
    stage's trajectory agrees with the CPU's within TRAJECTORY_ATOL, pose
    parameters over POSE_ROWS and the NCC over NCC_ROWS. cuDNN's TF32 is off
    on the card, so the CNN's initial poses agree to float32 sums."""
    import functools

    from xvr_tpu_torch.cli import main
    from xvr_tpu_torch.geometry.se3 import _shared_adjoint_plain
    from xvr_tpu_torch.render import _cuda
    from xvr_tpu_torch.render import shearwarp as sw

    smoke = _smoke()
    monkeypatch.setenv("XVR_FORCE_SHEARWARP", "1")  # the CPU run takes shear-warp too
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    for name in ("_accumulate", "_accumulate_adjoint", "_warp_plain", "_warp_with_grads_plain"):
        monkeypatch.setattr(sw, name, functools.partial(getattr(sw, name), bf16=False))
    hu, aff, fids = smoke.build_phantom(64)
    X, _, Z = np.meshgrid(*([np.arange(64, dtype=np.float32)] * 3), indexing="ij")
    hu = np.where(hu < -500.0, 20.0 + 150.0 * X / 64 + 60.0 * Z / 64, hu).astype(np.float32)
    smoke.write_deepfluoro_subject(tmp_path, "subject01", hu, aff, fids, dev="cuda", det=356)
    sub = tmp_path / "data" / "deepfluoro" / "subject01"
    ckpt = tmp_path / "models" / "deepfluoro" / "finetuned" / "subject01" / "0001.ckpt"
    # the registrar's first torch.autograd.grad, d NCC / d (rotation,
    # translation) at the init: the first call that no other call encloses
    # (the shear-warp backward calls it within, for its ray geometry)
    grads, autograd_grad, depth = {}, torch.autograd.grad, [0]

    def first_grad(run):
        def spy(outputs, inputs, *a, **k):
            depth[0] += 1
            try:
                g = autograd_grad(outputs, inputs, *a, **k)
            finally:
                depth[0] -= 1
            if depth[0] == 0 and run not in grads:  # copied once: a CUDA graph's capture follows
                grads[run] = [t.detach().double().cpu() for t in g]
            return g
        return spy

    def every_slab(fn):  # the plain versions read every slab: the operand's boxes are not theirs
        return lambda *a, boxes=None, **k: fn(*a, **k)

    plain = {"accumulate": every_slab(sw._accumulate),
             "accumulate_adjoint": every_slab(sw._accumulate_adjoint),
             "content_boxes": sw._content_boxes,
             "warp": sw._warp_plain, "warp_with_grads": sw._warp_with_grads_plain}
    out = {}
    for run, dev in (("cuda", "cuda"), ("cuda_plain", "cuda"), ("cpu", "cpu")):
        out[run] = tmp_path / f"out_{run}"
        _cuda.reset_launches()
        with monkeypatch.context() as m:
            m.setattr(torch.autograd, "grad", first_grad(run))
            for name, fn in plain.items() if run == "cuda_plain" else ():
                m.setattr(sw, name, fn)
            if run == "cuda_plain":
                m.setattr(_cuda, "rays_adjoint", _shared_adjoint_plain)
            assert main(["register", "model", str(sub / "xrays" / "000.dcm"), "-v",
                         str(sub / "volume.nii.gz"), "-m", str(sub / "mask.nii.gz"), "-c",
                         str(ckpt), "-o", str(out[run]), "--crop", "100", "--linearize",
                         "--labels", "1,2,3,4,7", "--scales", "24,12", "--n_itrs", "20,10",
                         "--restart_seeds", "1", "--max_restarts", "0", "--verbose", "0",
                         "--device", dev]) == 0
        launched = {k for k, v in _cuda.LAUNCHES.items() if v}
        assert launched == (set(smoke.REGISTER_SW) if run == "cuda" else set())
    assert [tuple(t.shape) for t in grads["cpu"]] == [(1, 3), (1, 3)]
    for i, what in enumerate(("rotation", "translation")):
        got = grads["cuda"][i]
        for run, rtol in (("cuda_plain", GRAD_RTOL_SAME_INPUTS), ("cpu", GRAD_RTOL_CPU[what])):
            ref = grads[run][i]
            print(f"first-iteration gradient, {what}: card {got.tolist()}, {run} {ref.tolist()}, "
                  f"max |diff| / max |{run}| {float((got - ref).abs().max() / ref.abs().max()):.3e}")
            torch.testing.assert_close(got, ref, rtol=rtol, atol=rtol * float(ref.abs().max()),
                                       msg=f"{what} against {run}")
    got, ref = (np.load(out[d] / "000" / "parameters.npz") for d in ("cuda", "cpu"))
    np.testing.assert_allclose(got["init_pose"], ref["init_pose"], rtol=0, atol=TRAJECTORY_ATOL)
    for key, rows in (("trajectory_params", POSE_ROWS), ("trajectory_ncc", NCC_ROWS)):
        np.testing.assert_allclose(got[key][:rows], ref[key][:rows], rtol=0, atol=TRAJECTORY_ATOL,
                                   err_msg=key)
