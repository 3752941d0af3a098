"""The port's evaluator script against the JAX package's (CPU).

``scripts/torch/evaluate.py`` is the twin of ``scripts/evaluate.py`` on
``xvr_tpu_torch``: the two tests of tests/test_evaluate.py run against it,
and two results trees, one written by the JAX package's ``register fixed``
and one by the port's (with an ``--init_only`` partition beside it), are
each scored by both scripts. The CSVs agree column for column: names,
strings and empty cells exactly, every number (mm, rad, NCC, seconds)
within 1e-4 absolute, since both evaluate the same float32 pose matrices in
float32 and differ only in the order of their sums.
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
from click.testing import CliRunner

from xvr_tpu.cli.cli import cli as jcli
from xvr_tpu.geometry import convert
from xvr_tpu.io import dcmwrite, save_nifti
from xvr_tpu.io.volumes import read as jread
from xvr_tpu.render import Projector as JProjector
from xvr_tpu_torch.cli import main as port_main
from torch_threads import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CSV_ATOL = 1e-4
MAPPER = np.diag([-1.0, -1.0, 1.0, 1.0]).astype(np.float32)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port_ev():
    return _load(REPO / "scripts" / "torch" / "evaluate.py", "torch_evaluate")


@pytest.fixture(scope="module")
def jax_ev():
    return _load(REPO / "scripts" / "evaluate.py", "jax_evaluate")


def _rows(path):
    lines = Path(path).read_text().strip().splitlines()
    header = lines[0].split(",")
    return [dict(zip(header, line.split(","))) for line in lines[1:]]


def test_evaluate_script_end_to_end(tmp_path, port_ev):
    data = tmp_path / "data" / "femur" / "subject01"
    (data / "xrays").mkdir(parents=True)

    n, c, sp = 24, 11.5, 4.0
    idx = np.arange(n)
    X, Y, Z = np.meshgrid(idx, idx, idx, indexing="ij")
    r2 = (X - c) ** 2 + (Y - c) ** 2 + (Z - c) ** 2
    hu = np.where(r2 <= 8**2, 500.0, -1000.0).astype(np.float32)
    aff = np.eye(4) * sp
    aff[3, 3] = 1.0
    aff[:3, 3] = -c * sp
    save_nifti(data / "volume.nii.gz", hu, aff)
    np.save(data / "fiducials.npy", np.array([[0.0, 0.0, 0.0], [10.0, -5.0, 8.0]], np.float32))

    gt_pose = convert(
        jnp.asarray([[180.0, 2.0, -1.0]]), jnp.asarray([[3.0, 220.0, -2.0]]),
        "euler_angles", "ZXY", degrees=True,
    )
    np.savez(
        data / "xrays" / "x1.npz",
        pose=np.asarray(gt_pose.matrix)[0],
        intrinsics_sdd=400.0, intrinsics_height=64, intrinsics_width=64,
        intrinsics_delx=4.0, intrinsics_dely=4.0, intrinsics_x0=0.0, intrinsics_y0=0.0,
    )

    # a "registration result": init 5 mm / 2 deg off; final = truth
    off = convert(
        jnp.asarray([[182.0, 2.0, -1.0]]), jnp.asarray([[3.0, 225.0, -2.0]]),
        "euler_angles", "ZXY", degrees=True,
    )
    res = tmp_path / "results" / "femur" / "subject01" / "x1"
    res.mkdir(parents=True)
    np.savez(
        res / "parameters.npz",
        init_pose=np.asarray(off.matrix), final_pose=np.asarray(gt_pose.matrix),
        trajectory_ncc=np.asarray([0.5, 0.99]),
    )
    (res / "parameters.json").write_text(json.dumps({"runtime": 1.25}))

    out_csv = tmp_path / "scores.csv"
    assert port_ev.main(["-f", str(tmp_path / "results"), "-s", str(out_csv),
                         "-d", str(tmp_path / "data"), "--device", "cpu"]) == 0
    (row,) = _rows(out_csv)
    assert row["subject"] == "subject01" and row["xray"] == "x1"
    assert float(row["mtre_init"]) > 1.0  # init is off
    assert float(row["mtre"]) < 1e-2  # final == truth
    assert float(row["runtime"]) == 1.25


def test_process_filenames_layouts(tmp_path, port_ev, jax_ev):
    """Path inference for result bundles: dataset/subject/xray, partition
    prefixes and checkpoint-epoch sweeps (subject/epoch/xray), as the JAX
    script infers them."""
    root = tmp_path / "results"
    paths = [
        root / "deepfluoro" / "subject01" / "xray0" / "parameters.npz",
        root / "finetune" / "ljubljana" / "subject02" / "frontal" / "parameters.npz",
        root / "deepfluoro" / "subject03" / "0250" / "xray7" / "parameters.npz",
    ]
    for p in paths:
        p.parent.mkdir(parents=True)
        p.touch()
    rows = port_ev.process_filenames(sorted(paths), root)
    assert rows == jax_ev.process_filenames(sorted(paths), root)
    by_subject = {r[3]: r for r in rows}

    _, dataset, partition, subject, epoch, xray = by_subject["subject01"]
    assert (dataset, epoch, xray) == ("deepfluoro", None, "xray0")

    _, dataset, partition, subject, epoch, xray = by_subject["subject02"]
    assert dataset == "ljubljana" and xray == "frontal"
    assert "finetune" in partition

    _, dataset, partition, subject, epoch, xray = by_subject["subject03"]
    assert (dataset, epoch, xray) == ("deepfluoro", "0250", "xray7")


def test_dataset_inferred_from_the_results_root(tmp_path, port_ev, jax_ev):
    """The evaluate scripts point -f at results/<dataset>/evaluate/<model>,
    below the dataset's name: the port finds the dataset in the root's own
    path (the nearest name), where the JAX script gives "unknown" and then
    skips every bundle for want of ground truth."""
    root = tmp_path / "femur" / "results" / "deepfluoro" / "evaluate" / "finetuned"
    paths = [root / "subject01" / "0001" / "000" / "parameters.npz",
             root / "subject02" / "0002" / "001" / "parameters.npz"]
    for p in paths:
        p.parent.mkdir(parents=True)
        p.touch()
    rows = port_ev.process_filenames(paths, root)
    jrows = jax_ev.process_filenames(paths, root)
    assert [r[1] for r in rows] == ["deepfluoro"] * 2 and [r[1] for r in jrows] == ["unknown"] * 2
    assert [r[2:] for r in rows] == [r[2:] for r in jrows] == [
        ("results", "subject01", "0001", "000"), ("results", "subject02", "0002", "001")]


def test_device_cuda_without_a_card_fails(tmp_path, port_ev, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_ev.main(["-f", str(tmp_path), "-s", str(tmp_path / "x.csv"), "-d", str(tmp_path)])


# ---------------------------------------------------------------------------
# each evaluator on the other package's results tree
# ---------------------------------------------------------------------------

SDD, DET, DELX = 400.0, 48, 4.0
GT = ([182.0, 2.0, -1.0], [3.0, 220.0, -2.0])  # ZXY degrees, mm
INIT = ([183.5, 1.0, 0.5], [5.0, 224.0, -4.0])


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A DeepFluoro-layout subject (two-tissue sphere, 48^2 X-ray, the pose
    stored before the mapper) and results trees of both packages'
    ``register fixed``; the port's also holds an --init_only partition."""
    d = tmp_path_factory.mktemp("teval")
    sub = d / "data" / "deepfluoro" / "subject01"
    (sub / "xrays").mkdir(parents=True)
    n, c, sp = 24, 11.5, 4.0
    idx = np.arange(n)
    X, Y, Z = np.meshgrid(idx, idx, idx, indexing="ij")
    r2 = (X - c) ** 2 + (Y - 0.8 * c) ** 2 + (Z - 1.1 * c) ** 2
    hu = np.where(r2 <= 8**2, 200.0, -1000.0).astype(np.float32)
    hu += np.where((r2 <= 4**2) | ((np.abs(X - 6) < 2) & (np.abs(Y - 14) < 3)), 800.0, 0.0)
    aff = np.eye(4) * sp
    aff[3, 3] = 1.0
    aff[:3, 3] = -c * sp
    save_nifti(sub / "volume.nii.gz", hu, aff)
    fids = np.random.default_rng(2).uniform(-30.0, 30.0, (6, 3)).astype(np.float32)
    np.save(sub / "fiducials.npy", fids)
    gt = convert(jnp.asarray([GT[0]]), jnp.asarray([GT[1]]), "euler_angles", "ZXY", degrees=True)
    img = np.asarray(JProjector.from_volume(jread(sub / "volume.nii.gz"), sdd=SDD, height=DET,
                                            delx=DELX)(gt))[0, 0]
    dcmwrite(sub / "xrays" / "x1.dcm", (img / img.max() * 60000).astype(np.uint16),
             sdd=SDD, row_spacing=DELX, col_spacing=DELX)
    np.savez(sub / "xrays" / "x1.npz", pose=MAPPER @ np.asarray(gt.matrix, np.float32),
             intrinsics_sdd=SDD, intrinsics_delx=DELX, intrinsics_dely=DELX, intrinsics_x0=0.0,
             intrinsics_y0=0.0, intrinsics_height=DET, intrinsics_width=DET)

    rot = [f"{np.deg2rad(v):.8f}" for v in INIT[0]]
    args = ["register", "fixed", str(sub / "xrays" / "x1.dcm"), "-v", str(sub / "volume.nii.gz"),
            "--rot", *rot, "--xyz", *[str(v) for v in INIT[1]], "--scales", "2",
            "--n_itrs", "8", "--max_restarts", "0", "--restart_seeds", "1", "--verbose", "0"]
    out = {"jax": d / "res_jax", "torch": d / "res_torch"}
    r = CliRunner().invoke(jcli, [*args, "-o", str(out["jax"] / "deepfluoro" / "subject01")])
    assert r.exit_code == 0, r.output
    assert port_main([*args, "-o", str(out["torch"] / "deepfluoro" / "subject01"),
                      "--device", "cpu"]) == 0
    assert port_main([*args, "-o", str(out["torch"] / "init" / "deepfluoro" / "subject01"),
                      "--init_only", "--device", "cpu"]) == 0
    return d, out


@pytest.mark.parametrize("tree", ["jax", "torch"])
def test_both_evaluators_score_each_tree_alike(trees, tree, port_ev, jax_ev):
    d, out = trees
    data = str(d / "data")
    port_csv, jax_csv = d / f"{tree}_by_port.csv", d / f"{tree}_by_jax.csv"
    assert port_ev.main(["-f", str(out[tree]), "-s", str(port_csv), "-d", data,
                         "--device", "cpu"]) == 0
    r = CliRunner().invoke(jax_ev.main, ["-f", str(out[tree]), "-s", str(jax_csv), "-d", data])
    assert r.exit_code == 0, r.output
    header = port_csv.read_text().splitlines()[0]
    assert header == jax_csv.read_text().splitlines()[0]
    got, ref = _rows(port_csv), _rows(jax_csv)
    assert len(got) == len(ref) == (2 if tree == "torch" else 1)
    for g, e in zip(got, ref):
        for col in header.split(","):
            try:
                a, b = float(g[col]), float(e[col])
            except ValueError:  # strings and empty cells
                assert g[col] == e[col], col
                continue
            assert abs(a - b) <= CSV_ATOL, (col, a, b)
    final = [row for row in ref if row["mtre"]]
    assert len(final) == 1 and float(final[0]["mtre_init"]) > 1.0
    if tree == "torch":
        init = [row for row in ref if not row["mtre"]]
        assert init[0]["partition"] == "init-deepfluoro" and init[0]["mtre_init"] == final[0]["mtre_init"]
