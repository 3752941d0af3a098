"""The foundation cell at a tiny size on the CPU: its files are found by
name, its reference imports nothing of the program, a run through the
port's plain versions (at the kernels' float32 arithmetic) is correct and
reports its padding, and each control, the reference put in the program's
place with one thing changed, and the fault of half the batch left out of
the loss are each not correct by the check they target."""

from __future__ import annotations

import ast
import copy
import functools
import os

import pytest
import torch

from portbench import harness

CONTROLS = {"bf16": "render_gap", "pick": "subject_gap", "every_k_1": "step_gap"}


@pytest.fixture(autouse=True)
def cpu_shearwarp(monkeypatch):
    monkeypatch.setenv("XVR_FORCE_SHEARWARP", "1")
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))


def kernel_arithmetic(mp) -> None:
    """K1-K4's plain versions at the kernels' float32 arithmetic (their
    default is the JAX package's bf16 recipe, which the bf16 control
    follows)."""
    from xvr_tpu_torch.render import shearwarp as sw

    for name in ("_accumulate", "_accumulate_adjoint", "_warp_plain", "_warp_with_grads_plain"):
        mp.setattr(sw, name, functools.partial(getattr(sw, name), bf16=False))


def tiny() -> dict:
    """The cell at 32 cubed: the subjects' depths scaled by 32 / 512, batch
    4 at 32 px; the warmup ends at the second update, so that it moves the
    parameters."""
    c = copy.deepcopy(harness.cell("train.foundation"))
    cfg = c["config"]
    cfg["ct"]["size"] = 32
    for s in cfg["subjects"]:
        s["depth"] = s["depth"] * 32 // 512
    cfg["trainer"].update(batch_size=4, height=32, delx=8.0, lr=1e-3, n_warmup_itrs=8,
                          n_total_itrs=400)
    return c


OWN = {"pad_share.foundation", "sw_roofline.foundation", "mfu.foundation"}
SHARED = {f"{k}.foundation" for k in (
    "idle_share", "draw_ms_per_step", "render_ms_per_step", "augment_ms_per_step",
    "cnn_ms_per_step", "loss_ms_per_step", "backward_ms_per_step", "optim_ms_per_step",
    "host_syncs_per_step", "aten_calls_per_step")}


def test_the_cell_reports_its_metrics_from_files_of_its_own_or_shared():
    """The cell's own readers, and the readers it shares with every
    training cell that has none of its own."""
    c = harness.cell("train.foundation")
    assert c["traffic"]["kind"] == "train_foundation"
    assert {m["name"] for m in c["end_to_end"]} == {"train_images_per_s", "setup_s"}
    names = {m["name"] for m in c["per_layer"]}
    assert names == OWN | SHARED
    for name in names:
        file = f"{name}.py" if name in OWN else f"{name.split('.')[0]}.py"
        assert harness.reader(name).__file__.endswith("/" + file), name
        assert harness.reader(name).read(dict(window_s=1.0, steps=0, kernel_s={})) is None


@pytest.mark.parametrize("name", ["reference_foundation.py", "counts_foundation.py"])
def test_the_reference_imports_nothing_of_the_program(name):
    tree = ast.parse((harness.PKG / name).read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not {m.split(".")[0] for m in mods} & {"xvr_tpu_torch", *harness.FORBIDDEN}


@pytest.fixture(scope="module")
def sound():
    """One run at the tiny size, the window one step, its spans and
    counters recorded; the padding's share as ``pad_share.foundation``
    reads it from the program's counters."""
    from xvr_tpu_torch.utils import profiling

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XVR_FORCE_SHEARWARP", "1")
        kernel_arithmetic(mp)
        c = tiny()
        drv = harness.driver("train_foundation")
        work = drv.Work(c["config"], c["traffic"], 3000000091, "cpu")
        work.setup()
        profiling.reset()
        profiling.enable()
        try:
            work.serve(0.0, 0.0, False)
            work.pad_share = harness.reader("pad_share.foundation").read(work.context())
        finally:
            profiling.enable(False)
            profiling.reset()
        checks, info = work.check()
    return c, work, checks, info


def test_a_run_through_the_plain_versions_is_correct(sound):
    c, work, checks, info = sound
    assert set(checks) == set(c["config"]["correct"])
    assert all(v["value"] <= v["limit"] for v in checks.values()), checks
    assert info["picks"] == info["picks_reference"] and len(set(info["picks"])) >= 2
    assert len(work.renderers) == 1 and work.renderers[0].endswith("_fast")
    assert len(work.perms) == 1
    shapes = [(32, 32, s["depth"]) for s in c["config"]["subjects"]]
    assert work.shapes == shapes and work.padded == (32, 32, 32)
    s = work.window_picks()[0]
    assert work.pad_share == pytest.approx(100.0 * (1.0 - shapes[s][2] / 32))


def test_the_window_work_counts_each_subject_at_its_own_shape(sound):
    from portbench.counts_foundation import subject_step_work, window_work

    _, work, _, _ = sound
    ctx = dict(work.context(), window_s=1.0)
    short, full = (subject_step_work(ctx, s) for s in (0, len(work.shapes) - 1))
    assert 0 < short["bound_s"] < full["bound_s"] and 0 < short["ops"] < full["ops"]
    assert window_work(ctx) == subject_step_work(ctx, ctx["window_picks"][0])


@pytest.mark.parametrize("kind", sorted(CONTROLS))
def test_each_control_is_not_correct(sound, kind):
    c, work, _, _ = sound
    values = work.control(kind)
    number = CONTROLS[kind]
    assert values[number] > c["config"]["correct"][number], (number, values[number])


def test_half_the_batch_left_out_of_the_loss_is_not_correct(sound):
    """The fault planted in the program (``control_foundation.fault``), read
    by the first loss; taken last, since it builds the run's trainer anew."""
    from portbench.control_foundation import fault

    c, work, _, _ = sound
    with pytest.MonkeyPatch.context() as mp:
        kernel_arithmetic(mp)
        values = fault(work, "half_batch")
    assert values["loss1_gap"] > c["config"]["correct"]["loss1_gap"], values["loss1_gap"]
