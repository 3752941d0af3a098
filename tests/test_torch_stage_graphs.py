"""The registrar's stage loop as CUDA graph replays, and the render glue it
needs: nothing in an iteration copies from the host.

On the CPU: ``shearwarp._decompose``'s gather, the similarity's Sobel and
Gaussian kernels, ``se3.make_matrix``'s bottom row and the PA flip give the
bits the host-copying forms gave (those forms are kept here as references);
the clock's tables give the host's arithmetic (written out here); and the
cache of graphed stages runs with a stand-in for the replay that steps the
buffers op by op. On the card (``pytest -m gpu``): the loop captured
against the loop run op by op at 4 and 32 poses a render, the cache of
graphs, and one host sync a replayed iteration.
"""

from __future__ import annotations

import collections
import importlib
import itertools
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from xvr_tpu_torch.geometry import convert, so3
from xvr_tpu_torch.geometry.se3 import make_matrix
from xvr_tpu_torch.io import dcmwrite, read, save_nifti
from xvr_tpu_torch.registrar import RegistrarFixed
from xvr_tpu_torch.registrar import base
from xvr_tpu_torch.render import Projector, _cuda
from xvr_tpu_torch.render import shearwarp as sw
from xvr_tpu_torch.render.projector import orientation_transform
from xvr_tpu_torch.utils import profiling
from xvr_tpu_torch.utils.device import device_constant
from torch_threads import two_torch_threads  # noqa: F401

ncc = importlib.import_module("xvr_tpu_torch.metrics.ncc")  # the package exports ncc()

SDD, HEIGHT, DELX = 400.0, 48, 4.0
REGISTER = dict(linearize=False, scales="2,1", n_itrs="30,20", reverse_x_axis=False,
                lr_rot=5e-3, lr_xyz=1.0, patience=3, max_n_plateaus=3, restart_seeds=4,
                max_restarts=1, coarse_seeds=0, verbose=0)


@pytest.fixture(autouse=True)
def _fresh_spans():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


# ---------------------------------------------------------------------------
# the render glue: the host-copying forms as references
# ---------------------------------------------------------------------------


def _decompose_gathered(affine_inverse, source, target, perm):
    """``_decompose`` with the list-indexed gather it had."""
    A = affine_inverse
    s_vox = source @ A[:3, :3].T + A[:3, 3]
    t_vox = target @ A[:3, :3].T + A[:3, 3]
    s_vox = s_vox.expand(t_vox.shape)
    d_vox = t_vox - s_vox
    raylen = torch.linalg.norm(target - source.expand(target.shape), dim=-1)
    order = list(perm)
    s_p, d_p = s_vox[..., order], d_vox[..., order]
    wscale = raylen / torch.clamp(torch.abs(d_p[..., 0]), min=1e-6)
    return s_p, d_p, wscale


@pytest.mark.parametrize("perm", list(itertools.permutations(range(3))))
def test_decompose_equals_the_list_gather(perm):
    """Every ``perm``: the fields and the gradients through them, bit for bit."""
    g = torch.Generator().manual_seed(sum(p * 3**i for i, p in enumerate(perm)))
    A = torch.linalg.inv(torch.eye(4) + 0.1 * torch.randn(4, 4, generator=g))
    A[3] = torch.tensor([0.0, 0.0, 0.0, 1.0])
    src = (torch.randn(3, 1, 3, generator=g) * 50.0).requires_grad_(True)
    tgt = (torch.randn(3, 20, 3, generator=g) * 80.0).requires_grad_(True)
    weights = [torch.randn(3, 20, 3, generator=g), torch.randn(3, 20, 3, generator=g),
               torch.randn(3, 20, generator=g)]
    got, want = sw._decompose(A, src, tgt, perm), _decompose_gathered(A, src, tgt, perm)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    g_got = torch.autograd.grad(got, (src, tgt), weights)
    g_want = torch.autograd.grad(want, (src, tgt), weights)
    for a, b in zip(g_got, g_want):
        assert torch.equal(a, b)


def _sobel_copied(x):
    kx = torch.tensor(ncc._SOBEL_X) / 8.0
    return torch.cat([ncc._depthwise2d(x, kx), ncc._depthwise2d(x, kx.T.contiguous())], dim=1)


def _blur_copied(x, sigma):
    radius = max(int(3.0 * sigma + 0.5), 1)
    t = torch.arange(-radius, radius + 1, dtype=x.dtype)
    k1 = torch.exp(-0.5 * (t / sigma) ** 2)
    k1 = k1 / k1.sum()
    return ncc._depthwise2d(ncc._depthwise2d(x, k1[None, :]), k1[:, None])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cached_sobel_and_blur_kernels_give_todays_bits(dtype):
    x = torch.randn(2, 3, 17, 23, generator=torch.Generator().manual_seed(5), dtype=dtype)
    assert torch.equal(ncc.sobel(x), _sobel_copied(x))
    for sigma in (0.7, 1.5):
        assert torch.equal(ncc.gaussian_blur(x, sigma), _blur_copied(x, sigma))
    kx = device_constant(ncc._SOBEL, dtype, x.device)
    assert kx is device_constant(ncc._SOBEL, dtype, x.device) and kx.dtype == dtype
    assert torch.equal(kx, (torch.tensor(ncc._SOBEL_X) / 8.0).to(dtype))


def test_device_constant_is_made_once_per_values_dtype_and_device():
    a = device_constant(((1.0, 2.5), (3.0, -4.0)), torch.float64, torch.device("cpu"))
    assert a is device_constant(((1.0, 2.5), (3.0, -4.0)), torch.float64, torch.device("cpu"))
    assert a.dtype == torch.float64 and a.tolist() == [[1.0, 2.5], [3.0, -4.0]]
    assert device_constant((1.0, 2.5), torch.float32, "cpu") is not device_constant(
        (1.0, 2.5), torch.float64, "cpu")
    i, j = so3._triu(torch.device("cpu"))
    assert i.dtype == j.dtype == torch.int64
    assert torch.equal(torch.stack([i, j]), torch.triu_indices(4, 4))
    assert so3._triu(torch.device("cpu"))[0] is i


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_make_matrix_bottom_row_is_todays(dtype):
    g = torch.Generator().manual_seed(7)
    R = torch.randn(5, 3, 3, generator=g, dtype=dtype).requires_grad_(True)
    t = torch.randn(5, 3, generator=g, dtype=dtype).requires_grad_(True)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype).expand(5, 1, 4)
    want = torch.cat([top, bottom], dim=-2)
    got = make_matrix(R, t)
    assert got.dtype == dtype and torch.equal(got, want)
    w = torch.randn(5, 4, 4, generator=g, dtype=dtype)
    for a, b in zip(torch.autograd.grad(got, (R, t), w), torch.autograd.grad(want, (R, t), w)):
        assert torch.equal(a, b)
    # one broadcast translation; the row is made once per dtype and device
    assert torch.equal(make_matrix(R[0].detach(), t.detach())[:, 3], bottom[:, 0])
    assert base.convert is convert


def test_pa_flip_is_todays():
    for dtype in (torch.float32, torch.float64):
        got = orientation_transform("PA", dtype, "cpu").matrix
        want = torch.diag(torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=dtype))
        assert torch.equal(got, want) and not torch.signbit(got[got == 0]).any()


# ---------------------------------------------------------------------------
# the clock
# ---------------------------------------------------------------------------


def test_device_clock_reads_the_host_clocks_values():
    """At every iteration the clock's tables give what the host computes from
    its count: the warmup, the patience tick, the iteration number, the
    record row, and Adam's bias corrections as a division by a Python float
    applies them (the CPU divides; the card multiplies by the float's
    float32 reciprocal, which the tables hold)."""
    rows, warmup = 64, 5.0
    clock = base._Clock(rows, warmup, torch.float32, "cpu")
    b1, b2 = torch.tensor(0.9), torch.tensor(0.999)
    g = torch.Generator().manual_seed(11)
    m, v = torch.randn(4, 3, generator=g), torch.rand(4, 3, generator=g)
    done = torch.zeros(4, dtype=torch.int32)
    rec_h, rec_d = torch.zeros(rows, 4), torch.zeros(rows, 4)
    for i in range(rows):
        t = torch.tensor(i + 1.0)
        c1, c2 = float(1 - b1**t), float(1 - b2**t)
        assert clock.ctr.tolist() == [i]
        assert clock.warm().tolist() == [np.float32(min((i + 1.0) / warmup, 1.0))]
        assert clock.ticking().tolist() == [i + 1.0 >= warmup]
        assert torch.equal(clock.itr(done).expand(4), torch.full_like(done, i + 1))
        got = clock.unbias(m, v)
        assert torch.equal(got[0], m / c1) and torch.equal(got[1], v / c2)
        for inv, c in ((clock.inv_c1, c1), (clock.inv_c2, c2)):
            assert inv[i].item() == np.float32(1.0) / np.float32(c)
        row = torch.full((4,), float(i))
        rec_h[i] = row
        clock.record(rec_d, row)
        clock.advance()
    assert torch.equal(rec_h, rec_d)


# ---------------------------------------------------------------------------
# the scene
# ---------------------------------------------------------------------------


def _phantom(n: int = 24, sp: float = 5.0):
    """A sphere of graded soft tissue with a bone core and two dense blocks."""
    c = (n - 1) / 2
    X, Y, Z = np.meshgrid(*([np.arange(n)] * 3), indexing="ij")
    r2 = (X - c) ** 2 + (Y - c) ** 2 + (Z - c) ** 2
    hu = np.where(r2 <= (0.45 * n) ** 2, 20.0 + 150.0 * X / n + 60.0 * Z / n, -1000.0)
    hu = np.where(r2 <= (n / 8) ** 2, 1000.0, hu).astype(np.float32)
    i = int(c)
    hu[i + 3 : i + 6, i - 2 : i + 2, i + 2 : i + 7] = 1500.0
    hu[i - 7 : i - 4, i + 2 : i + 5, i - 6 : i - 3] = 1800.0
    aff = np.eye(4) * sp
    aff[3, 3] = 1.0
    aff[:3, 3] = -c * sp
    return hu, aff


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The CT and two X-rays of it (the golden renderer at two views) ->
    (directory, rot init, xyz init)."""
    d = tmp_path_factory.mktemp("graphs")
    hu, aff = _phantom()
    save_nifti(d / "ct.nii.gz", hu, aff)
    proj = Projector.from_volume(read(d / "ct.nii.gz", device="cpu"), sdd=SDD, height=HEIGHT,
                                 delx=DELX)
    for k, rot in enumerate(([183.0, -2.0, 4.0], [178.0, 3.0, -2.0])):
        pose = convert(torch.tensor([rot]), torch.tensor([[2.0, 220.0, -3.0]]), "euler_angles",
                       "ZXY", degrees=True)
        with torch.no_grad():
            img = proj(pose)[0, 0].numpy()
        dcmwrite(d / f"xray{k}.dcm", (img / img.max() * 60000).astype(np.uint16), sdd=SDD,
                 row_spacing=DELX, col_spacing=DELX)
    rot0, xyz0 = pose.convert("euler_angles", "ZXY")
    rot_init = (rot0[0].numpy() + np.deg2rad([3.0, -2.0, 2.0])).tolist()
    xyz_init = (xyz0[0].numpy() + np.array([6.0, -8.0, 5.0])).tolist()
    return d, rot_init, xyz_init


def _registrar(scene, device, **kw):
    d, rot_init, xyz_init = scene
    return RegistrarFixed(volume=d / "ct.nii.gz", mask=None, orientation="AP", rot=rot_init,
                          xyz=xyz_init, device=device, **dict(REGISTER, **kw))


def _register(reg, scene, n_xrays):
    """``run_batch`` over ``n_xrays`` X-rays (the two, alternating) -> what
    the loop decided: the stages' iterations, the final poses and each
    X-ray's trajectory."""
    paths = [scene[0] / f"xray{k % 2}.dcm" for k in range(n_xrays)]
    mark = len(reg.stage_log)
    res = reg.run_batch(paths)
    out = dict(n_done=[r["n_done"] for r in reg.stage_log[mark:]],
               final=np.stack([r[4].matrix.detach().cpu().numpy() for r in res]))
    for key in ("params", "ncc", "lrs"):
        out[key] = [r[5]["trajectory"][key] for r in res]
    return out


def _gap(a, b) -> float:
    """The widest difference of two registrations' poses and records (inf
    where their lengths differ)."""
    if a["n_done"] != b["n_done"]:
        return float("inf")
    gaps = [float(np.abs(a["final"] - b["final"]).max())]
    for key in ("params", "ncc", "lrs"):
        for x, y in zip(a[key], b[key]):
            if x.shape != y.shape:
                return float("inf")
            gaps.append(float(np.abs(x - y).max()) if x.size else 0.0)
    return max(gaps)


# ---------------------------------------------------------------------------
# the cache of graphed stages on the CPU
# ---------------------------------------------------------------------------


def test_graphed_loop_bookkeeping_on_the_cpu(scene, monkeypatch):
    """Graphed stages with a stand-in for the replay (each iteration steps
    the buffers op by op): one cached stage a stage shape, one
    prepared-volume buffer shared by them, the same bits when a second
    registration of the same shape reuses them, and new entries for another
    K·S."""
    monkeypatch.setenv("XVR_FORCE_SHEARWARP", "1")
    monkeypatch.setattr(base, "_graphs_engage", lambda *a: True)
    monkeypatch.setattr(base._Stage, "_replay", lambda self: (self._step(), 1)[1])
    reg = _registrar(scene, "cpu", n_itrs="8,6")
    profiling.enable()
    graphed = _register(reg, scene, 1)
    counters = profiling.snapshot()["counters"]
    assert counters["register.graph_replays"] == counters["register.iterations"] == sum(
        graphed["n_done"])
    assert len(reg._stage_graphs) == 2
    entries = list(reg._stage_graphs.values())
    assert entries[0].prepared is entries[1].prepared  # one volume's buffer, shared
    assert _gap(_register(reg, scene, 1), graphed) == 0.0
    assert list(reg._stage_graphs.values()) == entries
    _register(reg, scene, 2)
    assert len(reg._stage_graphs) == 4


def test_graphs_engage_on_a_cuda_shear_warp_stage_alone():
    def proj(renderer, device="cuda"):
        return SimpleNamespace(renderer=renderer, device=torch.device(device))

    assert base._graphs_engage(proj("trilinear_fast"), None, "euler_angles")
    assert base._graphs_engage(proj("siddon_fast"), None, "quaternion")
    assert not base._graphs_engage(proj("trilinear_fast", "cpu"), None, "euler_angles")
    assert not base._graphs_engage(proj("trilinear_fast"), object(), "euler_angles")
    assert not base._graphs_engage(proj("trilinear_pallas"), None, "euler_angles")
    assert not base._graphs_engage(proj("trilinear"), None, "euler_angles")
    assert not base._graphs_engage(proj("trilinear_fast"), None, "rotation_10d")


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m gpu` on the card")
    return torch.device("cuda")


def _held_to_eager(scene, graphed, n_xrays, **kw):
    """Two registrations run op by op: where they agree bit for bit the
    graphed one must too, else it is held to their gap with equal
    iterations."""
    with pytest.MonkeyPatch.context() as mp:  # the loop op by op, as on a mesh
        mp.setattr(base, "_graphs_engage", lambda *a: False)
        runs = [_register(_registrar(scene, "cuda", **kw), scene, n_xrays) for _ in range(2)]
    spread = _gap(*runs)
    gap = _gap(graphed, runs[0])
    print(f"{n_xrays} X-rays, {kw}: graph against eager {gap:.3e}, eager against eager "
          f"{spread:.3e}, iterations {graphed['n_done']}")
    assert graphed["n_done"] == runs[0]["n_done"]
    assert gap <= spread, (gap, spread)


@pytest.mark.gpu
@pytest.mark.parametrize("n_xrays", [1, 8])
def test_graphed_loop_matches_the_eager_loop(cuda, scene, n_xrays):
    """K·S 4 and 32 poses a render, two stages, a re-anneal (which replays
    the first pass's graphs): iterations, trajectories, similarity records,
    lrs and final poses."""
    profiling.enable()
    reg = _registrar(scene, "cuda")
    graphed = _register(reg, scene, n_xrays)
    counters = profiling.snapshot()["counters"]
    assert reg.projector.renderer == "trilinear_fast"
    assert counters["register.graph_captures"] == 2  # one a stage shape
    # every iteration but each graph's first (op by op) is a replay, the
    # captured one too
    assert counters["register.graph_replays"] == counters["register.iterations"] - 2
    _held_to_eager(scene, graphed, n_xrays)


@pytest.mark.gpu
def test_graphs_are_cached_by_what_they_read(cuda, scene):
    """A second registration with the same intrinsics captures nothing and
    replays every iteration; another detector (scales) or K·S captures anew
    and still matches the eager loop."""
    profiling.enable()
    reg = _registrar(scene, "cuda")
    _register(reg, scene, 1)
    before = profiling.snapshot()["counters"]
    again = _register(reg, scene, 1)
    after = profiling.snapshot()["counters"]
    assert after["register.graph_captures"] == before["register.graph_captures"]
    assert (after["register.graph_replays"] - before["register.graph_replays"]
            == after["register.iterations"] - before["register.iterations"] == sum(again["n_done"]))
    reg.scales = ["3", "1.5"]
    other_detector = _register(reg, scene, 1)
    mid = profiling.snapshot()["counters"]
    assert mid["register.graph_captures"] == after["register.graph_captures"] + 2
    _held_to_eager(scene, other_detector, 1, scales="3,1.5")
    other_batch = _register(reg, scene, 2)
    assert profiling.snapshot()["counters"]["register.graph_captures"] == (
        mid["register.graph_captures"] + 2)
    _held_to_eager(scene, other_batch, 2, scales="3,1.5")


def _synchronizing_calls(work) -> tuple[int, list]:
    """``work`` under ``set_sync_debug_mode("warn")`` -> (``host_syncs``
    counted, the synchronizing calls reported, by file and line)."""
    torch.cuda.synchronize()
    profiling.reset()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        profiling.enable()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            work()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            profiling.enable(False)
    seen = [f"{w.filename}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]
    return profiling.snapshot()["counters"].get("host_syncs", 0), seen


@pytest.mark.gpu
def test_a_replayed_iteration_syncs_once(cuda, scene):
    """With every plateau budget unspent (each stage runs its n_itr), six
    more replayed iterations a stage make exactly six more host syncs a
    stage, each counted."""
    reg = _registrar(scene, "cuda", max_n_plateaus=1000, max_restarts=0)
    reg.n_itrs = [6, 6]
    work = lambda: reg.run(scene[0] / "xray0.dcm")  # noqa: E731
    work()  # builds, warms and captures
    _synchronizing_calls(work)  # the debug mode's first use reports one call of its own
    counted, seen = {}, {}
    for n in (6, 12):
        reg.n_itrs = [n, n]
        counted[n], seen[n] = _synchronizing_calls(work)
        assert counted[n] == len(seen[n]), sorted(set(seen[n]))
    assert len(seen[12]) - len(seen[6]) == 2 * 6


@pytest.mark.gpu
def test_replays_launch_one_graph_inside_their_span(cuda, scene):
    """A replayed registration: one ``register.replay`` span an iteration,
    each holding its graph's launch."""
    from torch.autograd import DeviceType

    reg = _registrar(scene, "cuda")
    _register(reg, scene, 1)
    torch.cuda.synchronize()
    profiling.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _register(reg, scene, 1)
        torch.cuda.synchronize()
    snap = profiling.snapshot()
    n = snap["counters"]["register.iterations"]
    assert snap["spans"]["register.replay"]["count"] == snap["counters"][
        "register.graph_replays"] == n
    events = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
              for ev in prof.profiler.kineto_results.events() if ev.device_type() == DeviceType.CPU]
    replays = [(s, e) for name, s, e in events if name == profiling.PREFIX + "register.replay"]
    graph_launches = [(s, e) for name, s, e in events if name.startswith("cudaGraphLaunch")]
    assert len(graph_launches) == n
    assert all(any(a <= s and e <= b for a, b in replays) for s, e in graph_launches)


# the kernel each launch function of LAUNCHES starts, by a part of its name
# on the device
_SW_KERNELS = {"sw_accumulate": "sw_accumulate_tiled_kernel", "sw_warp": "sw_warp_kernel",
               "sw_warp_grads": "sw_warp_grads_kernel",
               "sw_accumulate_adjoint": "sw_adjoint_tiled_kernel",
               "rays_adjoint": "rays_adjoint_kernel"}


@pytest.mark.gpu
def test_replays_count_the_kernels_they_run(cuda, scene):
    """Over a replayed registration ``_cuda.LAUNCHES`` grows by the K1-K4
    and ``rays_adjoint`` kernels the device ran, as the profiler counts them
    (the capture's own launches, recorded and not run, are not counted)."""
    from torch.autograd import DeviceType

    reg = _registrar(scene, "cuda")
    _register(reg, scene, 1)  # builds, warms and captures
    torch.cuda.synchronize()
    before = dict(_cuda.LAUNCHES)
    profiling.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _register(reg, scene, 1)
        torch.cuda.synchronize()
    counters = profiling.snapshot()["counters"]
    assert counters["register.graph_replays"] == counters["register.iterations"] > 0
    events = list(prof.profiler.kineto_results.events())
    launcher = {ev.correlation_id(): ev.name() for ev in events
                if ev.device_type() == DeviceType.CPU and "Launch" in ev.name()}
    for k, name in _SW_KERNELS.items():
        ran = [launcher.get(ev.correlation_id()) for ev in events
               if ev.device_type() != DeviceType.CPU and name in ev.name()]
        counted = _cuda.LAUNCHES[k] - before[k]
        assert counted == len(ran) > 0, (k, counted, collections.Counter(ran))
