"""The port's spans and counters (``xvr_tpu_torch.utils.profiling``) in the
registrar's loop and the training step.

On the CPU: tracing off records nothing and opens no profiler event; a
span is a host operator event (never a user annotation, which the profiler
mirrors onto the device's timeline); under a ``torch.profiler`` session a
tiny registration
and a training step record their spans, nested as documented, in the
profiler's trace too, with one request id per ``run_batch`` or step, the
loop's iterations counted as ``stage_log`` counts them, and results bit for
bit those of a run with tracing off. On the card (``pytest -m gpu``):
``host_syncs`` counts every synchronizing call that
``torch.cuda.set_sync_debug_mode("warn")`` reports (the registration's
iterations replayed as CUDA graphs), and the leaf spans cover the kernel
and graph launches, of the replayed loop and of the loop run op by op.
"""

from __future__ import annotations

import warnings
from bisect import bisect_right

import numpy as np
import pytest
import torch

from xvr_tpu_torch.geometry import convert
from xvr_tpu_torch.io import dcmwrite, read, save_nifti
from xvr_tpu_torch.registrar import RegistrarFixed
from xvr_tpu_torch.render import Projector
from xvr_tpu_torch.utils import profiling
from torch_threads import two_torch_threads  # noqa: F401

SDD, HEIGHT, DELX = 400.0, 48, 4.0
REGISTER = dict(linearize=False, scales="2,1", n_itrs="4,4", reverse_x_axis=False, lr_rot=5e-3,
                lr_xyz=1.0, max_n_plateaus=4, restart_seeds=2, max_restarts=1, coarse_seeds=0,
                verbose=0)
TRAIN = dict(alphamin=165.0, alphamax=195.0, betamin=-15.0, betamax=15.0, gammamin=-15.0,
             gammamax=15.0, txmin=-10.0, txmax=10.0, tymin=150.0, tymax=250.0, tzmin=-10.0,
             tzmax=10.0, sdd=SDD, height=32, delx=4.0, model_name="resnet18", batch_size=4,
             n_total_itrs=4, n_warmup_itrs=1, n_grad_accum_itrs=1, n_save_every_itrs=100,
             lr=1e-3, p_augmentation=0.5, seed=3)
STAGE_SPANS = ("register.buffers", "register.render", "register.similarity", "register.backward",
               "register.update", "register.exit_check")
TRAIN_SPANS = ("train.subject", "train.draw", "train.render", "train.augment", "train.cnn",
               "train.loss", "train.backward", "train.optim")
PARENTS = {"register.request": None, "register.read": "register.request",
           "register.prepare": "register.request", "register.seed": "register.request",
           "register.stage": "register.request", "register.save": None,
           **{k: "register.stage" for k in STAGE_SPANS}}
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")  # and their Ex forms


@pytest.fixture(autouse=True)
def _fresh_spans():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def _profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _host_events(prof) -> list:
    """(name, start ns, end ns) of the trace's host events."""
    from torch.autograd import DeviceType

    return [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
            for ev in prof.profiler.kineto_results.events() if ev.device_type() == DeviceType.CPU]


# ---------------------------------------------------------------------------
# the scene
# ---------------------------------------------------------------------------


def _phantom(n: int = 24, sp: float = 5.0):
    """A sphere of soft tissue with a gradient, a bone core and three dense
    blocks -> (hu, affine, labels 0..2)."""
    c = (n - 1) / 2
    X, Y, Z = np.meshgrid(*([np.arange(n)] * 3), indexing="ij")
    r2 = (X - c) ** 2 + (Y - c) ** 2 + (Z - c) ** 2
    hu = np.where(r2 <= (0.45 * n) ** 2, 20.0 + 150.0 * X / n + 60.0 * Z / n, -1000.0)
    hu = np.where(r2 <= (n / 8) ** 2, 1000.0, hu).astype(np.float32)
    i = int(c)
    hu[i + 3 : i + 6, i - 2 : i + 2, i + 2 : i + 7] = 1500.0
    hu[i - 7 : i - 4, i + 2 : i + 5, i - 6 : i - 3] = 1800.0
    labels = np.where(hu > 500.0, 2, np.where(hu > -500.0, 1, 0)).astype(np.float32)
    aff = np.eye(4) * sp
    aff[3, 3] = 1.0
    aff[:3, 3] = -c * sp
    return hu, aff, labels


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The CT, its labelmap and two X-rays of it (the golden renderer at two
    views) -> (directory, rot init, xyz init)."""
    d = tmp_path_factory.mktemp("tracing")
    hu, aff, labels = _phantom()
    save_nifti(d / "ct.nii.gz", hu, aff)
    save_nifti(d / "mask.nii.gz", labels, aff)
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


def _registrar(scene, device="cpu", **kw):
    d, rot_init, xyz_init = scene
    return RegistrarFixed(volume=d / "ct.nii.gz", mask=d / "mask.nii.gz", orientation="AP",
                          labels="1,2", rot=rot_init, xyz=xyz_init, device=device,
                          **dict(REGISTER, **kw))


def _register_files(scene, out, traced: bool):
    """Two X-rays registered one request each through ``register_files``
    (bundles saved). -> (registrar, the bundles' arrays, kineto host events)."""
    d = scene[0]
    reg = _registrar(scene)
    prof = _profiler("cpu") if traced else None
    if prof is not None:
        prof.__enter__()
    try:
        paths = reg.register_files([d / "xray0.dcm", d / "xray1.dcm"], out, max_batch=1)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    bundles = [dict(np.load(p / "parameters.npz")) for p in paths]
    return reg, bundles, _host_events(prof) if prof is not None else []


@pytest.fixture(scope="module")
def registered(scene, tmp_path_factory):
    """The registration with tracing off, then traced -> (off, on, snapshot
    of the traced run)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XVR_FORCE_SHEARWARP", "1")
        profiling.reset()
        off = _register_files(scene, tmp_path_factory.mktemp("off"), traced=False)
        assert profiling.snapshot()["records"] == []
        on = _register_files(scene, tmp_path_factory.mktemp("on"), traced=True)
        snap = profiling.snapshot()
        profiling.reset()
    return off, on, snap


def _train_files(tmp_path):
    hu, aff, labels = _phantom()
    save_nifti(tmp_path / "ct.nii.gz", hu, aff)
    save_nifti(tmp_path / "mask.nii.gz", labels, aff)
    return tmp_path / "ct.nii.gz", tmp_path / "mask.nii.gz"


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


def test_tracing_off_records_nothing(monkeypatch):
    """Off, ``span`` hands out one shared no-op, ``count`` adds nothing, and
    no profiler event is opened."""
    def refuse(*a, **kw):
        raise AssertionError("a profiler event opened while tracing is off")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    first, second = profiling.span("register.render"), profiling.span("train.step", request=True)
    assert first is second
    with first:
        profiling.count("register.iterations", 3)
        profiling.host_sync("cuda")
    assert profiling.snapshot() == dict(spans={}, counters={}, records=[])


def test_host_syncs_count_the_card_alone():
    """A host sync counts where the tensor or device is a CUDA device's."""
    profiling.enable()
    profiling.host_sync(torch.zeros(2))
    profiling.host_sync("cpu", 3)
    assert profiling.snapshot()["counters"] == {}
    profiling.host_sync("cuda", 2)
    profiling.host_sync(torch.device("cuda", 0))
    assert profiling.snapshot()["counters"] == {"host_syncs": 3}


def test_spans_nest_and_add_up_when_enabled(monkeypatch):
    """``enable()`` records without a profiler (no profiler event): a
    parent's self time is its time less its children's, a count goes to
    the innermost open span, and a request's id holds until the next one."""
    def refuse(*a, **kw):
        raise AssertionError("a profiler event opened without a profiler")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    profiling.enable()
    with profiling.span("outer", request=True):
        with profiling.span("inner"):
            profiling.count("host_syncs", 2)
        with profiling.span("inner"):
            pass
        profiling.count("host_syncs")
    with profiling.span("after"):
        pass
    with profiling.span("next", request=True):
        pass
    snap = profiling.snapshot()
    outer, inner = snap["spans"]["outer"], snap["spans"]["inner"]
    assert (outer["count"], inner["count"]) == (1, 2)
    assert outer["self_seconds"] == pytest.approx(outer["seconds"] - inner["seconds"], abs=1e-9)
    assert snap["counters"] == {"host_syncs": 3}
    assert (inner["counters"], outer["counters"]) == ({"host_syncs": 2}, {"host_syncs": 1})
    rec = {r["name"]: r for r in snap["records"]}
    assert rec["inner"]["parent"] == rec["outer"]["id"] and rec["outer"]["parent"] is None
    assert rec["after"]["request"] == rec["outer"]["request"] != rec["next"]["request"]
    profiling.reset()
    assert profiling.snapshot() == dict(spans={}, counters={}, records=[])


def test_a_span_is_a_host_operator_event():
    with _profiler("cpu") as prof:
        with profiling.span("register.render"):
            torch.ones(4).sum()
    evs = [ev for ev in prof.profiler.kineto_results.events()
           if ev.name() == profiling.PREFIX + "register.render"]
    assert len(evs) == 1 and not evs[0].is_user_annotation()


@pytest.mark.parametrize("name", sorted(PARENTS))
def test_register_span_is_in_the_profiler_trace(registered, name):
    _, (_, _, events), snap = registered
    names = {n for n, _, _ in events}
    assert snap["spans"][name]["count"] > 0
    assert profiling.PREFIX + name in names
    assert not any(n.startswith("aten::") for n in snap["spans"])


def test_register_spans_nest(registered):
    """request > read, prepare, seed, stage > the six spans of the loop;
    save after the request; the loop's spans tile a stage but for its
    set-up."""
    _, _, snap = registered
    by_id = {r["id"]: r for r in snap["records"]}
    for r in snap["records"]:
        parent = by_id[r["parent"]]["name"] if r["parent"] is not None else None
        assert parent == PARENTS[r["name"]], r["name"]
    stage = snap["spans"]["register.stage"]
    inner = sum(snap["spans"][k]["seconds"] for k in STAGE_SPANS)
    assert inner == pytest.approx(stage["seconds"] - stage["self_seconds"], rel=1e-9)
    assert snap["spans"]["register.backward"]["count"] == snap["counters"]["register.iterations"]


def test_one_request_id_per_run_batch(registered):
    (reg, _, _), _, snap = registered
    requests = [r for r in snap["records"] if r["name"] == "register.request"]
    assert len(requests) == 2 and requests[0]["request"] != requests[1]["request"]
    for req in requests:
        inside = [r for r in snap["records"]
                  if req["start_ns"] <= r["start_ns"] and r["end_ns"] <= req["end_ns"]]
        assert {r["request"] for r in inside} == {req["request"]}
    # each bundle is written after its request, under its id
    saves = [r for r in snap["records"] if r["name"] == "register.save"]
    assert [s["request"] for s in saves] == [r["request"] for r in requests]


def test_register_iterations_are_stage_logs(registered):
    (reg_off, _, _), (reg_on, _, _), snap = registered
    n_done = sum(r["n_done"] for r in reg_on.stage_log)
    assert snap["counters"]["register.iterations"] == n_done > 0
    assert snap["spans"]["register.stage"]["count"] == len(reg_on.stage_log)
    assert "host_syncs" not in snap["counters"]  # on the CPU nothing waits on a device
    assert [r["n_done"] for r in reg_off.stage_log] == [r["n_done"] for r in reg_on.stage_log]


def test_registration_is_bit_identical_with_tracing(registered):
    (_, off, _), (_, on, _), _ = registered
    assert len(off) == len(on) == 2
    for a, b in zip(off, on):
        for key in ("final_pose", "trajectory_params", "trajectory_ncc", "trajectory_lrs"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_training_step_spans_and_bit_identity(tmp_path, monkeypatch):
    """A step traced opens ``train.step`` once and each of its spans once
    under it (``train.render`` twice: the targets and the re-render), and
    moves the parameters exactly as the same step untraced."""
    from xvr_tpu_torch.train import Trainer

    monkeypatch.setenv("XVR_FORCE_SHEARWARP", "1")
    ct, mask = _train_files(tmp_path)
    off, on = (Trainer(ct, mask, tmp_path / name, **TRAIN, device="cpu") for name in ("a", "b"))
    assert off.route()["renderer"] == "trilinear_fast"
    off.step(0)
    assert profiling.snapshot()["records"] == []
    with _profiler("cpu") as prof:
        on.step(0)
    snap = profiling.snapshot()
    for k, v in off.params.items():
        assert torch.equal(v, on.params[k]), k
    counts = {k: v["count"] for k, v in snap["spans"].items()}
    assert counts == {"train.step": 1, **{k: 1 for k in TRAIN_SPANS}, "train.render": 2}
    step = next(r for r in snap["records"] if r["name"] == "train.step")
    assert all(r["parent"] == step["id"] and r["request"] == step["request"]
               for r in snap["records"] if r is not step)
    names = {n for n, _, _ in _host_events(prof)}
    assert {profiling.PREFIX + k for k in counts} <= names
    inner = sum(snap["spans"][k]["seconds"] for k in TRAIN_SPANS)
    assert inner == pytest.approx(snap["spans"]["train.step"]["seconds"]
                                  - snap["spans"]["train.step"]["self_seconds"], rel=1e-9)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m gpu` on the card")
    return torch.device("cuda")


def _card_work(kind, scene, tmp_path):
    """One request of a one-stage registration, or one training step (after
    a first that builds, warms and captures the stage's graph), on the card
    -> the call. ``register_eager``: the registration's loop runs op by op,
    as it does on a mesh and on the slab kernels (the caller forces it)."""
    if kind.startswith("register"):
        reg = _registrar(scene, "cuda", scales="2", n_itrs="6")
        reg.run(scene[0] / "xray0.dcm")
        return lambda: reg.run(scene[0] / "xray1.dcm")
    from xvr_tpu_torch.train import Trainer

    ct, mask = _train_files(tmp_path)
    tr = Trainer(ct, mask, tmp_path / "out", **TRAIN, device="cuda")
    tr.step(0)
    return lambda: tr.step(1)


def _syncs(work) -> tuple[int, list]:
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
@pytest.mark.parametrize("kind", ["register", "train"])
def test_host_syncs_count_every_synchronizing_call(cuda, scene, tmp_path, kind):
    work = _card_work(kind, scene, tmp_path)
    _syncs(work)  # the debug mode's first use in a process reports one call of its own
    counted, seen = _syncs(work)
    assert counted == len(seen), sorted(set(seen))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["register", "train", "register_eager"])
def test_leaf_spans_cover_the_kernel_launches(cuda, scene, tmp_path, monkeypatch, kind):
    """A registration's launches (a replayed iteration's graph launch, and
    the stage's set-up, scoring and copies around the replays) lie in leaf
    spans, and so do those of the loop run op by op and of a training
    step."""
    if kind == "register_eager":
        from xvr_tpu_torch.registrar import base

        monkeypatch.setattr(base, "_graphs_engage", lambda *a: False)
    work = _card_work(kind, scene, tmp_path)
    torch.cuda.synchronize()
    with _profiler("cuda") as prof:
        work()
        torch.cuda.synchronize()
    snap = profiling.snapshot()
    parents = {r["parent"] for r in snap["records"]}
    leaves = {profiling.PREFIX + r["name"] for r in snap["records"] if r["id"] not in parents}
    events = _host_events(prof)
    on_device = [ev.name() for ev in prof.profiler.kineto_results.events()
                 if ev.device_type() != torch.autograd.DeviceType.CPU]
    assert not any(n.startswith(profiling.PREFIX) for n in on_device)
    spans = sorted((s, e) for n, s, e in events if n in leaves)
    starts = [s for s, _ in spans]
    launches = [(s, e) for n, s, e in events if n.startswith(LAUNCHES)]
    inside = 0
    for s, e in launches:
        j = bisect_right(starts, s) - 1
        inside += j >= 0 and spans[j][0] <= s and e <= spans[j][1]
    assert launches and inside >= 0.95 * len(launches), (inside, len(launches))
