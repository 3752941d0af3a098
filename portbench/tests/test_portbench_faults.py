"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have; and the register cells' control (the reference
computed in bfloat16 in the program's place) departs from the reference by
more than the limit. The look for a card is skipped: the runs are on the
CPU, at a size a test run holds, through the port's plain versions."""

from __future__ import annotations

import copy
import os

import pytest
import torch

from portbench import harness

TINY_REGISTER = dict(ct=64, xray=356, n_itrs="10,10,10")


@pytest.fixture(autouse=True)
def cpu_shearwarp(monkeypatch):
    monkeypatch.setenv("XVR_FORCE_SHEARWARP", "1")
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))


def tiny(workload: str, init=(2.0, 12.0)) -> dict:
    c = copy.deepcopy(harness.cell(workload))
    cfg, tr = c["config"], c["traffic"]
    if tr["kind"] == "register":
        cfg["ct"]["size"] = TINY_REGISTER["ct"]
        cfg["xray"].update(size=TINY_REGISTER["xray"], spacing=0.194 * 1436 / TINY_REGISTER["xray"])
        cfg["registrar"]["n_itrs"] = TINY_REGISTER["n_itrs"]
        tr.update(pool=2, batch=min(tr["batch"], 2), max_requests=4, warmup_itrs=1, init=list(init),
                  control_requests=1)
    else:
        cfg["ct"]["size"] = 32
        cfg["trainer"].update(batch_size=4, height=32, delx=8.0)
    return c


def run(c, seed=3000000021):
    return harness.run_cell(c, seed, 0.0, False, 0.0, device="cpu")


def _frozen_stage(monkeypatch):
    from xvr_tpu_torch.registrar.base import RegistrarBase

    make = RegistrarBase._make_stage

    def broken(self, *a, **kw):
        stage, transform = make(self, *a, **kw)
        return (lambda rot, xyz, gt, density, lr_rot, lr_xyz:
                stage(rot, xyz, gt, density, 0.0, 0.0)), transform

    monkeypatch.setattr(RegistrarBase, "_make_stage", broken)


def _altered_pose(monkeypatch):
    from xvr_tpu_torch.geometry import RigidTransform
    from xvr_tpu_torch.registrar.base import RegistrarBase

    batch = RegistrarBase.run_batch

    def broken(self, *a, **kw):
        out = []
        for gt, intr, proj, init, final, kwargs in batch(self, *a, **kw):
            m = final.matrix.clone()
            m[..., :3, 3] += 5.0
            out.append((gt, intr, proj, init, RigidTransform(m), kwargs))
        return out

    monkeypatch.setattr(RegistrarBase, "run_batch", broken)


def _altered_similarity(monkeypatch):
    from xvr_tpu_torch.registrar.base import RegistrarBase

    batch = RegistrarBase.run_batch

    def broken(self, *a, **kw):
        out = batch(self, *a, **kw)
        for r in out:
            r[5]["trajectory"]["ncc"][-1] += 0.01
        return out

    monkeypatch.setattr(RegistrarBase, "run_batch", broken)


def _half_batch(monkeypatch):
    from xvr_tpu_torch.registrar.base import RegistrarBase

    batch = RegistrarBase.run_batch

    def broken(self, i2ds, *a, **kw):
        h = max(len(i2ds) // 2, 1)
        itrs = self.n_itrs
        self.n_itrs = [0] * len(itrs)  # the second half is left out of the optimization
        try:
            rest = batch(self, i2ds[h:], *a, **kw) if i2ds[h:] else []
        finally:
            self.n_itrs = itrs
        return batch(self, i2ds[:h], *a, **kw) + rest

    monkeypatch.setattr(RegistrarBase, "run_batch", broken)


def _one_left_at_init(monkeypatch):
    from xvr_tpu_torch.registrar.base import RegistrarBase

    batch = RegistrarBase.run_batch

    def broken(self, *a, **kw):
        out = batch(self, *a, **kw)
        gt, intr, proj, init, final, kwargs = out[-1]
        out[-1] = (gt, intr, proj, init, init, kwargs)
        return out

    monkeypatch.setattr(RegistrarBase, "run_batch", broken)


REGISTER_FAULTS = {"state_unchanged": (_frozen_stage, "mpd_max_mm"),
                   "answer_altered": (_altered_pose, "mpd_max_mm"),
                   "similarity_altered": (_altered_similarity, "sim_gap")}


@pytest.mark.parametrize("fault", sorted(REGISTER_FAULTS))
def test_register_intraop_fault_is_not_correct(monkeypatch, fault):
    plant, number = REGISTER_FAULTS[fault]
    plant(monkeypatch)
    res = run(tiny("register.intraop"))
    assert res["correct"] is False
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


@pytest.mark.parametrize("fault", ["half_batch", "one_left_at_init"])
def test_register_sweep8_fault_is_not_correct(monkeypatch, fault):
    {"half_batch": _half_batch, "one_left_at_init": _one_left_at_init}[fault](monkeypatch)
    res = run(tiny("register.sweep8"))
    assert res["correct"] is False
    assert res["checks"]["mpd_max_mm"]["value"] > res["checks"]["mpd_max_mm"]["limit"]


def test_register_control_departs_from_the_reference():
    """The reference in bfloat16 in the program's place, at the views and
    initial poses of three seeds' requests, against the float32 reference."""
    from portbench.control import register_readings

    c = tiny("register.intraop", init=(0.8, 4.0))
    for seed in (3000000031, 3000000032, 3000000033):
        r = register_readings(c, seed, device="cpu")
        assert r["control_sim_gap"] > c["config"]["correct"]["sim_gap"]
        assert r["one_unchanged_mpd_max_mm"] > c["config"]["correct"]["mpd_max_mm"]


def _unchanged_optimizer(monkeypatch):
    from xvr_tpu_torch.train.optim import AGCAdamMultiSteps

    monkeypatch.setattr(AGCAdamMultiSteps, "step", lambda self, params, grads, state: False)


def _train_loss(monkeypatch, how):
    from xvr_tpu_torch.train import trainer as tmod

    original = tmod.pose_regression_loss

    def half(img, fg, pose, pimg, pfg, ppose, keep, sdd, **kw):
        keep = keep.clone()
        keep[keep.shape[0] // 2:] = 0.0
        return original(img, fg, pose, pimg, pfg, ppose, keep, sdd, **kw)

    def altered(*a, **kw):
        loss, metrics = original(*a, **kw)
        return loss * 1.1, metrics

    monkeypatch.setattr(tmod, "pose_regression_loss", half if how == "half" else altered)


TRAIN_FAULTS = {"state_unchanged": (_unchanged_optimizer, "step_gap"),
                "half_batch": (lambda mp: _train_loss(mp, "half"), "loss1_gap"),
                "loss_altered": (lambda mp: _train_loss(mp, "altered"), "loss1_gap")}


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_finetune_fault_is_not_correct(monkeypatch, fault):
    plant, number = TRAIN_FAULTS[fault]
    plant(monkeypatch)
    res = run(tiny("train.finetune"))
    assert res["correct"] is False
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]



def test_train_control_departs_from_the_reference():
    """The reference with its renders in bfloat16 in the program's place,
    through the checked steps of three seeds, against the float32
    reference."""
    from portbench.control import train_readings

    c = tiny("train.finetune")
    for seed in (3000000051, 3000000052, 3000000053):
        r = train_readings(c, seed, "reference_bf16", device="cpu")
        assert r["render_gap"] > c["config"]["correct"]["render_gap"], r["render_gap"]
