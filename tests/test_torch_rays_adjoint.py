"""The detector rays' pose gradient: ``se3.transform_shared`` and the
``rays_adjoint`` kernel.

On the CPU: the forward is the expression ``Detector.rays`` used before,
bit for bit, the plain backward is autograd's own product through it (so
every CPU path keeps its bits), and the gradients pass ``gradcheck`` in
float64. On the card (``pytest -m gpu``): the kernel against the plain
version at the registrar's shapes, identical bits over two calls, its launch
count, and the wrapper's checks. No JAX: the card's machine need not have it.
"""

from __future__ import annotations

import pytest
import torch

from xvr_tpu_torch.geometry import Detector, RigidTransform, convert
from xvr_tpu_torch.geometry.se3 import _shared_adjoint_plain, transform_shared
from torch_threads import two_torch_threads  # noqa: F401

BATCHES = {"unbatched": (), "B1": (1,), "B4": (4,), "B32": (32,)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m gpu` on the card")
    return torch.device("cuda")


def _detector(height: int) -> Detector:
    # the registrar's detector at this size: 239^2 at 1.6 mm is the fine stage
    # of the bench X-ray (1436^2 at 0.194 mm, cropped by 100)
    return Detector(sdd=1020.0, height=height, width=height, delx=1.6 * 239 / height,
                    dely=1.6 * 239 / height, x0=1.5, y0=-2.5)


def _poses(batch, seed=0, dtype=torch.float32, device="cpu") -> RigidTransform:
    g = torch.Generator().manual_seed(seed)
    rot = torch.randn(batch + (3,), generator=g, dtype=torch.float64) * 8.0
    rot = rot + torch.tensor([180.0, 0.0, 0.0], dtype=torch.float64)
    xyz = torch.randn(batch + (3,), generator=g, dtype=torch.float64) * 20.0
    xyz = xyz + torch.tensor([0.0, 750.0, 0.0], dtype=torch.float64)
    pose = convert(rot, xyz, "euler_angles", "ZXY", degrees=True)
    return RigidTransform(pose.matrix.to(dtype=dtype, device=device))


def _calibration(dtype=torch.float32) -> RigidTransform:
    rot = torch.tensor([[0.5, -1.0, 0.25]], dtype=torch.float64)
    xyz = torch.tensor([[1.0, -3.0, 2.0]], dtype=torch.float64)
    return RigidTransform(convert(rot, xyz, "euler_angles", "ZXY", degrees=True).matrix[0]
                          .to(dtype))


def _points(det: Detector, calibrated: bool, dtype=torch.float32, device="cpu"):
    q = det._target_grid(dtype, "cpu")
    return (_calibration(dtype).apply(q[None])[0] if calibrated else q).to(device)


def _todays_rays(det: Detector, pose: RigidTransform, calibration=None):
    """``Detector.rays`` as it was: the pose applied to the expanded grid."""
    m = pose.matrix
    target_cam = det._target_grid(m.dtype, m.device)
    source_cam = torch.zeros((1, 3), dtype=m.dtype, device=m.device)
    if calibration is not None:
        source_cam = calibration(source_cam[None])[0]
        target_cam = calibration(target_cam[None])[0]
    batch = pose.batch_shape
    return (pose(source_cam.expand(batch + (1, 3))),
            pose(target_cam.expand(batch + (det.n_rays, 3))))


def _cotangent(shape, seed=1, dtype=torch.float32, device="cpu"):
    """A detector cotangent like a loss's: a smooth field that changes sign
    across the detector, plus noise."""
    g = torch.Generator().manual_seed(seed)
    x = torch.linspace(-1.0, 1.0, shape[-2], dtype=torch.float64)
    smooth = torch.stack([torch.sin(3 * x), torch.cos(2 * x), x], dim=-1)
    out = smooth + 0.3 * torch.randn(shape, generator=g, dtype=torch.float64)
    return out.to(dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# the CPU: the forward's bits, the plain backward, gradcheck
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("calibrated", [False, True], ids=["grid", "calibrated"])
@pytest.mark.parametrize("batch", BATCHES.values(), ids=BATCHES.keys())
@pytest.mark.parametrize("height", [60, 128])
def test_forward_is_the_expanded_product(height, batch, calibrated):
    det = _detector(height)
    q = _points(det, calibrated)
    m = _poses(batch).matrix
    ref = q.expand(batch + q.shape) @ m[..., :3, :3].transpose(-1, -2) + m[..., None, :3, 3]
    assert torch.equal(transform_shared(m, q), ref)


@pytest.mark.parametrize("calibrated", [False, True], ids=["grid", "calibrated"])
@pytest.mark.parametrize("batch", BATCHES.values(), ids=BATCHES.keys())
@pytest.mark.parametrize("height", [60, 128])
def test_plain_backward_is_autograds_product(height, batch, calibrated):
    """The CPU backward gives the bits autograd gave through the expression,
    for the pose and, when they require it, for the points."""
    det = _detector(height)
    q0 = _points(det, calibrated)
    m0 = _poses(batch).matrix
    g = _cotangent(batch + q0.shape)
    grads = []
    for fn in (lambda m, q: RigidTransform(m)(q.expand(batch + q.shape)), transform_shared):
        m, q = m0.clone().requires_grad_(True), q0.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(m, q), (m, q), g))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])
    assert torch.equal(_shared_adjoint_plain(g, q0), grads[1][0])


@pytest.mark.parametrize("batch", BATCHES.values(), ids=BATCHES.keys())
def test_gradcheck_float64(batch):
    det = _detector(60)
    m = _poses(batch, dtype=torch.float64).matrix.requires_grad_(True)
    q = _points(det, True, torch.float64).requires_grad_(True)
    assert torch.autograd.gradcheck(transform_shared, (m, q), fast_mode=True)


@pytest.mark.parametrize("batch", [(1,), (4,), (32,)], ids=["B1", "B4", "B32"])
@pytest.mark.parametrize("height", [60, 128])
def test_float32_adjoint_within_its_rounding(height, batch):
    """The float32 adjoint against float64 of the same inputs: each entry
    within 1e-6 of the magnitude it sums, sum_n |g_i q_j| (|g_i| for the
    translation), the bound a float32 sum of these terms keeps."""
    det = _detector(height)
    q = _points(det, True)
    g = _cotangent(batch + q.shape)
    got = _shared_adjoint_plain(g, q).double()
    ref = _shared_adjoint_plain(g.double(), q.double())
    scale = _shared_adjoint_plain(g.double().abs(), q.double().abs())
    assert float((got - ref).abs().max()) > 0.0  # float32 rounds
    assert bool(((got - ref).abs() <= 1e-6 * scale).all())


@pytest.mark.parametrize("calibrated", [False, True], ids=["grid", "calibrated"])
@pytest.mark.parametrize("batch", BATCHES.values(), ids=BATCHES.keys())
def test_detector_rays_keep_their_values_and_gradients(batch, calibrated):
    """``Detector.rays`` against its former expression: rays and the
    gradients of the pose parameters (and the calibration's), bit for bit."""
    det = _detector(60)
    outs = []
    for fn in (lambda *a: _todays_rays(det, *a), det.rays):
        g = torch.Generator().manual_seed(3)
        rot = (torch.tensor([180.0, 2.0, -3.0]) + torch.randn(batch + (3,), generator=g))
        xyz = (torch.tensor([3.0, 740.0, -2.0]) + torch.randn(batch + (3,), generator=g))
        rot, xyz = rot.requires_grad_(True), xyz.requires_grad_(True)
        cal = _calibration().matrix.clone().requires_grad_(True)
        pose = convert(rot, xyz, "euler_angles", "ZXY", degrees=True)
        src, tgt = fn(pose, RigidTransform(cal)) if calibrated else fn(pose)
        w = _cotangent(tgt.shape, seed=4)
        loss = (tgt * w).sum() + 1e-3 * (src**2).sum()
        wrt = (rot, xyz, cal) if calibrated else (rot, xyz)
        outs.append((src.detach(), tgt.detach(), *torch.autograd.grad(loss, wrt)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("height", [60, 120, 239])
@pytest.mark.parametrize("B", [4, 32])
def test_kernel_matches_plain(cuda, B, height):
    """The kernel at the registrar's shapes against the plain version in
    float64 of the same float32 inputs: to 1e-6 of each pose's largest entry
    (its double sums round once, to float32); in float64 to 1e-12. Two calls
    give identical bits."""
    from xvr_tpu_torch.render import _cuda

    q = _points(_detector(height), True, device=cuda)
    g = _cotangent((B,) + q.shape, device=cuda)
    got = _cuda.rays_adjoint(g, q)
    ref = _shared_adjoint_plain(g.double(), q.double())
    err = (got.double() - ref).abs().amax(dim=(-1, -2)) / ref.abs().amax(dim=(-1, -2))
    assert float(err.max()) <= 1e-6, err.tolist()
    assert torch.equal(got[:, 3], torch.zeros_like(got[:, 3]))
    assert torch.equal(got, _cuda.rays_adjoint(g, q))
    g64, q64 = g.double(), q.double()
    ref64 = _shared_adjoint_plain(g64, q64)
    err = (_cuda.rays_adjoint(g64, q64) - ref64).abs().amax(dim=(-1, -2))
    assert float((err / ref64.abs().amax(dim=(-1, -2))).max()) <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [(), (4,)], ids=["unbatched", "B4"])
def test_rays_gradient_launches_the_kernel_once(cuda, batch):
    """A pose gradient through ``Detector.rays`` on the card runs the kernel,
    once, and agrees with the CPU's; a forward alone runs nothing."""
    from xvr_tpu_torch.render import _cuda

    det = _detector(120)
    grads = {}
    for dev in ("cpu", cuda):
        m = _poses(batch, device=dev).matrix.clone().requires_grad_(True)
        _cuda.reset_launches()
        src, tgt = det.rays(RigidTransform(m))
        assert _cuda.LAUNCHES["rays_adjoint"] == 0
        w = _cotangent(tgt.shape, seed=5, device=dev)
        (grads[str(dev)],) = torch.autograd.grad((tgt * w).sum() + (src**2).sum(), m)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {"rays_adjoint": 1}
    ref = grads["cpu"].double()
    torch.testing.assert_close(grads[str(cuda)].cpu().double(), ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.gpu
def test_wrapper_checks_its_inputs(cuda):
    from xvr_tpu_torch.render import _cuda

    g = torch.zeros((2, 10, 3), device=cuda)
    q = torch.zeros((10, 3), device=cuda)
    with pytest.raises(TypeError, match="float32 or float64"):
        _cuda.rays_adjoint(g.half(), q.half())
    with pytest.raises(TypeError, match="float32"):
        _cuda.rays_adjoint(g, q.double())
    with pytest.raises(ValueError, match="shape"):
        _cuda.rays_adjoint(g, q[:9])
    with pytest.raises(ValueError, match="contiguous"):
        _cuda.rays_adjoint(g.transpose(0, 1).contiguous().transpose(0, 1), q)
    with pytest.raises(ValueError, match="on cpu"):
        _cuda.rays_adjoint(g, q.cpu())
