"""The harness: cells found by name, the result line, no fallback to the
CPU, and no JAX anywhere in the benchmark or its reference."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_loads_its_files_by_name(workload):
    c = harness.cell(workload)
    entry = next(w for w in BENCH["workloads"] if w["name"] == workload)
    assert (PKG / "traffic" / f"{entry['traffic']}.json").is_file()
    assert (PKG / "drivers" / f"{c['traffic']['kind']}.py").is_file()
    assert hasattr(harness.driver(c["traffic"]["kind"]), "Work")
    assert {m["name"] for m in c["end_to_end"]} >= {"setup_s"}
    assert len(c["end_to_end"]) >= 2 and c["per_layer"]
    for m in c["per_layer"]:
        assert callable(harness.reader(m["name"]).read)


def test_every_configuration_and_metric_has_its_own_file():
    for conf in BENCH["configs"]:
        assert json.loads((ROOT / conf["file"]).read_text())["name"] == conf["name"]
    for m in BENCH["per_layer"]:
        name = m["name"]
        assert ((PKG / "metrics" / f"{name}.py").is_file()
                or (PKG / "metrics" / f"{name.split('.')[0]}.py").is_file()), name
        assert set(m["workloads"]) <= set(CELLS)


def test_a_metric_file_of_its_own_is_read_before_the_shared_one():
    assert harness.reader("sw_roofline.train").__file__.endswith("sw_roofline.train.py")
    assert harness.reader("sw_roofline.sweep").__file__.endswith("sw_roofline.py")
    assert harness.reader("idle_share.train").__file__.endswith("idle_share.py")
    for m in BENCH["end_to_end"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_readers_return_nothing_when_there_is_nothing_to_read():
    ctx = dict(window_s=1.0, requests=[], kernel_s={}, busy_s=0.0, steps=0)
    for m in BENCH["per_layer"]:
        if m["name"].split(".")[-1] == "train":
            continue
        ctx.update(stage_dets=[], restart_seeds=4, vol_shape=(8, 8, 8), affine_inverse=None)
        assert harness.reader(m["name"]).read(dict(ctx)) is None, m["name"]


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), (path, tops & set(harness.FORBIDDEN))


@pytest.mark.parametrize("name", ["reference.py", "reference_train.py", "scene.py", "counts.py",
                                  "trace.py"])
def test_the_reference_imports_nothing_of_the_program(name):
    tops = {n.split(".")[0] for n in _imports(PKG / name)}
    assert "xvr_tpu_torch" not in tops
    assert tops <= {"__future__", "contextlib", "math", "struct", "pathlib", "json", "collections",
                    "numpy", "torch", "portbench"}


def test_forbidden_names_are_compared_whole():
    saved = dict(sys.modules)
    try:
        sys.modules["xvr_tpu_torch_like"] = sys
        assert harness.forbidden_modules() == []
        sys.modules["xvr_tpu.render"] = sys
        assert harness.forbidden_modules() == ["xvr_tpu.render"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def _run(cwd: Path, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                           "3000000019", "--seconds", "1", "--trace", "0"], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)


def test_the_measurement_path_fails_without_a_card_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = _run(ROOT, env)
    assert res.returncode != 0
    assert not res.stdout.strip()
    assert "CUDA device" in res.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PKG, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path, dict(os.environ, PYTHONPATH=""))
    assert res.returncode != 0
    assert not res.stdout.strip()


def test_the_result_line_has_the_driver_keys_and_the_checks_last(monkeypatch):
    class Work:
        def __init__(self, *a):
            pass

        def setup(self):
            pass

        def serve(self, t0, seconds, trace):
            return dict(attempted=3, failed=0, e2e={"register_s": 2.0})

        def check(self):
            return {"mtre_mm": dict(value=0.5, limit=2.0)}, {}

        def context(self):
            return {}

    monkeypatch.setattr(harness, "driver", lambda kind: type("M", (), {"Work": Work}))
    c = harness.cell(CELLS[0])
    res = harness.run_cell(c, 1, 0.0, False, 0.0, device="cpu")
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True
    assert set(res["metrics"]) == {m["name"] for m in c["end_to_end"]}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    json.dumps(res)
