"""On the card, at each register cell's own size: the control departs from
the reference by more than the limit of ``correct``, and so does the fault
"a state left unchanged", on three seeds; and each of the training cell's
two controls fails its number. Marked ``gpu``; skipped where there is no
card (``python -m pytest portbench/tests -m gpu`` on the card)."""

from __future__ import annotations

import pytest
import torch

from portbench import harness

SEEDS = (3000000041, 3000000042, 3000000043)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    harness.isolate_caches()
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["register.intraop", "register.sweep8"])
def test_register_control_fails_at_full_size(card, workload):
    from portbench.control import register_readings

    c = harness.cell(workload)
    for seed in SEEDS:
        r = register_readings(c, seed, device=card)
        assert r["control_sim_gap"] > c["config"]["correct"]["sim_gap"]
        assert r["one_unchanged_mpd_max_mm"] > c["config"]["correct"]["mpd_max_mm"]


@pytest.mark.gpu
def test_train_controls_fail_at_full_size(card):
    """The reference with its renders in bfloat16 fails ``render_gap``; the
    program's own bfloat16 path fails ``cnn1_gap``."""
    from portbench.control import train_readings

    c = harness.cell("train.finetune")
    lim = c["config"]["correct"]
    for seed in SEEDS:
        assert train_readings(c, seed, "reference_bf16", card)["render_gap"] > lim["render_gap"]
        assert train_readings(c, seed, "program_bf16", card)["cnn1_gap"] > lim["cnn1_gap"]

