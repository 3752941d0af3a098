"""The port's command line against the JAX package's (CPU).

``python -m xvr_tpu_torch.cli register ...`` runs on ``argparse``; its option
surface is read here beside the JAX package's click commands, which stay the
contract: every option name and short flag, default, ``nargs``, choice list,
range and help category is the same, and the only extra option is
``--device``. The register tests of tests/test_cli.py are mirrored with
``--device cpu``, and ``register model`` from a JAX-written checkpoint starts
from the JAX package's pose (to 1e-4 of the pose matrix's largest entry,
tests/test_torch_models.py). ``animate`` and ``dcm2nii`` take the JAX
commands' options and run on a registration bundle and a DICOM series.
"""

import argparse
import json
import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import click
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from click.testing import CliRunner

from xvr_tpu.cli.cli import cli as jcli
from xvr_tpu.cli.commands import register as jregister
from xvr_tpu.geometry import convert as jconvert
from xvr_tpu.io import dcmwrite, save_nifti
from xvr_tpu.io.volumes import read as jread
from xvr_tpu.render import Projector as JProjector
from xvr_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from xvr_tpu_torch.cli import build_parser, main
from xvr_tpu_torch.cli.commands import register

REPO = Path(__file__).resolve().parents[1]
SUBCOMMANDS = ("model", "dicom", "fixed", "restart")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """tests/test_cli.py's scene: a 24^3 two-tissue sphere and its 48^2 X-ray."""
    d = tmp_path_factory.mktemp("tcli")
    n, c, sp = 24, 11.5, 4.0
    idx = np.arange(n)
    X, Y, Z = np.meshgrid(idx, idx, idx, indexing="ij")
    r2 = (X - c) ** 2 + (Y - c) ** 2 + (Z - c) ** 2
    hu = np.where(r2 <= 8**2, 200.0, -1000.0).astype(np.float32)
    hu += np.where(r2 <= 4**2, 800.0, 0.0)
    aff = np.eye(4) * sp
    aff[3, 3] = 1.0
    aff[:3, 3] = -c * sp
    save_nifti(d / "ct.nii.gz", hu, aff)
    proj = JProjector.from_volume(jread(d / "ct.nii.gz"), sdd=400.0, height=48, delx=4.0)
    pose = jconvert(jnp.asarray([[180.0, 2.0, -1.0]]), jnp.asarray([[3.0, 220.0, -2.0]]),
                    "euler_angles", "ZXY", degrees=True)
    img = np.asarray(proj(pose))[0, 0]
    dcmwrite(d / "xray.dcm", (img / img.max() * 60000).astype(np.uint16),
             sdd=400.0, row_spacing=4.0, col_spacing=4.0)
    return d


def _click_surface(cmd):
    out = {}
    for p in cmd.params:
        if isinstance(p, click.Argument):
            out[p.name] = dict(opts=[], nargs="+" if p.nargs == -1 else p.nargs,
                               required=p.required)
            continue
        t = p.type
        out[p.name] = dict(
            # click 8.2+ marks "no default" with a sentinel; argparse with None
            opts=sorted(p.opts), default=None if repr(p.default) == "Sentinel.UNSET" else p.default,
            nargs=p.nargs, required=p.required,
            flag=p.is_flag, choices=list(getattr(t, "choices", []) or []) or None,
            range=(t.min, t.max) if isinstance(t, click.IntRange) else None,
            category=p.category,
        )
    return out


def _subparsers(parser) -> dict:
    return next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction)).choices


def _argparse_surface(parser):
    out = {}
    for name, p in _subparsers(_subparsers(parser)["register"]).items():
        category = {id(a): g.title.removesuffix(" options")
                    for g in p._action_groups for a in g._group_actions}
        acts = {}
        for a in p._actions:
            if isinstance(a, argparse._HelpAction):
                continue
            if not a.option_strings:
                acts[a.dest] = dict(opts=[], nargs=a.nargs, required=a.required)
                continue
            flag = isinstance(a, argparse._StoreTrueAction)
            acts[a.dest] = dict(
                opts=sorted(a.option_strings), default=a.default,
                nargs=1 if a.nargs is None or flag else a.nargs, required=a.required, flag=flag,
                choices=list(a.choices) if a.choices else None,
                range=(a.type.lo, a.type.hi) if isinstance(a.type, register.IntRange) else None,
                category=category[id(a)],
            )
        out[name] = acts
    return out


def test_option_surface_matches_click():
    ours = _argparse_surface(build_parser())
    assert sorted(ours) == sorted(SUBCOMMANDS)
    for name in SUBCOMMANDS:
        theirs = _click_surface(getattr(jregister, name))
        mine = dict(ours[name])
        assert mine.pop("device") == dict(
            opts=["--device"], default="cuda", nargs=1, required=False, flag=False,
            choices=["cuda", "cpu"], range=None, category="Optimizer")
        assert sorted(mine) == sorted(theirs), name
        for opt, spec in theirs.items():
            assert mine[opt] == spec, (name, opt, mine[opt], spec)
    groups = _subparsers(_subparsers(build_parser())["register"])["model"]._action_groups
    assert [g.title.removesuffix(" options") for g in groups[2:]] == register.CATEGORY_ORDER
    assert register.CATEGORY_ORDER[:-1] == jregister.BaseRegistrar(name="x").category_order[:-1]


def test_version_and_help(capsys):
    with pytest.raises(SystemExit) as e:
        main(["--version"])
    assert e.value.code == 0 and "version" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        main(["register", "--help"])
    out = capsys.readouterr().out
    assert e.value.code == 0 and all(sub in out for sub in SUBCOMMANDS)
    with pytest.raises(SystemExit) as e:
        main(["register", "fixed", "--help"])
    out = capsys.readouterr().out
    assert e.value.code == 0 and "clinical presets" in out and "Optimizer options" in out


def test_module_help_runs_without_jax_click_or_msgpack(tmp_path):
    """``python -m xvr_tpu_torch.cli register <sub> --help`` with jax, flax,
    click and msgpack made unimportable."""
    for name in ("jax", "flax", "optax", "click", "msgpack"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(f"raise ImportError('no {name} here')\n")
    for sub in SUBCOMMANDS:
        res = subprocess.run([sys.executable, "-m", "xvr_tpu_torch.cli", "register", sub, "--help"],
                             cwd=REPO, capture_output=True, text=True, timeout=120,
                             env={"PYTHONPATH": f"{tmp_path}:{REPO}", "PATH": "/usr/bin:/bin"})
        assert res.returncode == 0 and "--device" in res.stdout, res.stderr


def test_directory_glob_init_only(workdir, tmp_path):
    xdir = tmp_path / "xrays"
    xdir.mkdir()
    shutil.copy(workdir / "xray.dcm", xdir / "a.dcm")
    shutil.copy(workdir / "xray.dcm", xdir / "b.dcm")
    (xdir / "ignored.txt").write_text("not a dicom")
    res = tmp_path / "results"
    assert main([
        "register", "fixed", str(xdir), "-v", str(workdir / "ct.nii.gz"), "-o", str(res),
        "--rot", "3.18", "0.0", "0.0", "--xyz", "0.0", "225.0", "0.0",
        "--pattern", "*.dcm", "--init_only", "--verbose", "0", "--device", "cpu",
    ]) == 0
    assert (res / "a" / "parameters.npz").exists() and (res / "b" / "parameters.npz").exists()
    assert not (res / "ignored").exists()
    d = np.load(res / "a" / "parameters.npz")
    assert "init_pose" in d.files and "final_pose" not in d.files


def test_defaults_match_reference():
    """The CLI passes every option explicitly, with the reference schedule
    (n_itrs 500, no linearize, no reverse_x_axis): the API's clinical
    presets do not leak through."""
    for name, p in _argparse_surface(build_parser()).items():
        kw = {dest: spec.get("default") for dest, spec in p.items()}
        assert kw["n_itrs"] == "500" and kw["scales"] == "8", name
        assert kw["linearize"] is False and kw["reverse_x_axis"] is False, name
        effective = register._base_kwargs(kw)
        assert effective["n_itrs"] == "500" and effective["linearize"] is False
        assert effective["mesh"] is None and effective["device"] == "cuda"


def test_register_model_gives_jax_init(workdir, tmp_path):
    """From a checkpoint written by the JAX package, ``register model
    --init_only`` writes the JAX CLI's init pose."""
    ckpt_mod = importlib.util.spec_from_file_location("chip_smoke_cli", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(ckpt_mod)
    ckpt_mod.loader.exec_module(cs)
    from xvr_tpu_torch.geometry import RigidTransform

    config = {**cs.MODEL_CONFIG, "model_name": "resnet18", "height": 32, "delx": 6.0, "sdd": 400.0}
    gt = jconvert(jnp.asarray([[180.0, 2.0, -1.0]]), jnp.asarray([[3.0, 220.0, -2.0]]),
                  "euler_angles", "ZXY", degrees=True)
    cs.synthetic_checkpoint(tmp_path / "port.ckpt", RigidTransform(torch.tensor(np.asarray(gt.matrix))),
                            workdir / "xray.dcm", config=config, device="cpu")
    from xvr_tpu_torch.train import load_checkpoint

    params = jax.tree.map(jnp.asarray, load_checkpoint(tmp_path / "port.ckpt")["model_state_dict"])
    ckpt = j_save_checkpoint(tmp_path / "jax.ckpt", params, optax.adam(1e-3).init(params), 5, 2,
                             config)
    args = ["register", "model", str(workdir / "xray.dcm"), "-v", str(workdir / "ct.nii.gz"),
            "-c", str(ckpt), "--init_only", "--verbose", "0"]
    r = CliRunner().invoke(jcli, args + ["-o", str(tmp_path / "jax")], catch_exceptions=False)
    assert r.exit_code == 0, r.output
    assert main(args + ["-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    jpose = np.load(tmp_path / "jax" / "xray" / "parameters.npz")["init_pose"]
    pose = np.load(tmp_path / "port" / "xray" / "parameters.npz")["init_pose"]
    np.testing.assert_allclose(pose, jpose, rtol=0, atol=1e-4 * np.abs(jpose).max())


def test_refusals(workdir, tmp_path):
    """``--n_devices`` above 1 with ``--device cpu`` raises (a device mesh
    needs that many CUDA devices; the CPU is one); ``--device cuda`` without
    a card raises."""
    args = ["register", "fixed", str(workdir / "xray.dcm"), "-v", str(workdir / "ct.nii.gz"),
            "-o", str(tmp_path), "--rot", "3.18", "0", "0", "--xyz", "0", "225", "0",
            "--init_only", "--verbose", "0"]
    with pytest.raises(ValueError, match="--n_devices 2: a device mesh needs 2 CUDA devices"):
        main(args + ["--device", "cpu", "--n_devices", "2"])
    with pytest.raises(SystemExit):
        main(args + ["--device", "tpu"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda is accepted here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)


# ---------------------------------------------------------------------------
# train and restart
# ---------------------------------------------------------------------------


def _command_surface(p: argparse.ArgumentParser, int_range=register.IntRange):
    """One argparse command's options in :func:`_click_surface`'s terms."""
    category = {id(a): g.title.removesuffix(" options")
                for g in p._action_groups for a in g._group_actions}
    acts = {}
    for a in p._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        flag = isinstance(a, argparse._StoreTrueAction)
        acts[a.dest] = dict(
            opts=sorted(a.option_strings), default=a.default,
            nargs=1 if a.nargs is None or flag else a.nargs, required=a.required, flag=flag,
            choices=list(a.choices) if a.choices else None,
            range=(a.type.lo, a.type.hi) if isinstance(a.type, int_range) else None,
            category=category[id(a)],
        )
    return acts


@pytest.mark.parametrize("name", ["train", "restart"])
def test_train_restart_surface_matches_click(name):
    """Every option of the JAX package's ``train``/``restart`` click command
    (name, short flag, default, nargs, choices, help category), and
    ``--device`` besides; the help groups follow the click category order."""
    from xvr_tpu.cli.commands import restart as jrestart_mod, train as jtrain_mod
    from xvr_tpu_torch.cli.commands import restart as trestart_mod, train as ttrain_mod

    cmd = {"train": jtrain_mod.train, "restart": jrestart_mod.restart}[name]
    theirs = _click_surface(cmd)
    parser = _subparsers(build_parser())[name]
    mine = _command_surface(parser)
    assert mine.pop("device") == dict(opts=["--device"], default="cuda", nargs=1, required=False,
                                      flag=False, choices=["cuda", "cpu"], range=None,
                                      category="TPU")
    assert sorted(mine) == sorted(theirs)
    for opt, spec in theirs.items():
        assert mine[opt] == spec, (name, opt, mine[opt], spec)
    order = {"train": ttrain_mod.CATEGORY_ORDER, "restart": trestart_mod.CATEGORY_ORDER}[name]
    assert [g.title.removesuffix(" options") for g in parser._action_groups[2:]] == order
    if name == "train":
        assert order == cmd.category_order


def test_train_restart_help_without_jax_click_or_msgpack(tmp_path):
    for name in ("jax", "flax", "optax", "click", "msgpack"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(f"raise ImportError('no {name} here')\n")
    for sub in ("train", "restart"):
        res = subprocess.run([sys.executable, "-m", "xvr_tpu_torch.cli", sub, "--help"],
                             cwd=REPO, capture_output=True, text=True, timeout=120,
                             env={"PYTHONPATH": f"{tmp_path}:{REPO}", "PATH": "/usr/bin:/bin"})
        assert res.returncode == 0 and "--device" in res.stdout, res.stderr
    res = subprocess.run([sys.executable, "-m", "xvr_tpu_torch.cli", "--help"], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": f"{tmp_path}:{REPO}", "PATH": "/usr/bin:/bin"})
    assert all(c in res.stdout for c in ("train", "restart", "register")), res.stderr


@pytest.fixture
def two_torch_threads():
    """Two torch threads for a test that trains: the suite runs several
    workers on one machine, and each worker's torch would otherwise start a
    thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    """tests/test_train.py's tiny dataset: a 24^3 two-tissue sphere and its
    bone core as label 1."""
    d = tmp_path_factory.mktemp("train")
    n = 24
    c = (n - 1) / 2
    idx = np.arange(n)
    X, Y, Z = np.meshgrid(idx, idx, idx, indexing="ij")
    r2 = (X - c) ** 2 + (Y - c) ** 2 + (Z - c) ** 2
    hu = np.where(r2 <= (n / 3) ** 2, 200.0, -1000.0).astype(np.float32)
    hu += np.where(r2 <= (n / 6) ** 2, 800.0, 0.0)
    aff = np.eye(4) * 4.0
    aff[3, 3] = 1.0
    aff[:3, 3] = -c * 4.0
    save_nifti(d / "volume.nii.gz", hu, aff)
    save_nifti(d / "mask.nii.gz", np.where(r2 <= (n / 6) ** 2, 1.0, 0.0).astype(np.float32), aff)
    return d


TRAIN_ARGS = ["--r1", "165", "195", "--r2", "-15", "15", "--r3", "-15", "15", "--tx", "-10", "10",
              "--ty", "150", "250", "--tz", "-10", "10", "--sdd", "400", "--height", "32",
              "--delx", "4.0", "--model_name", "resnet18", "--batch_size", "3", "--lr", "1e-3",
              "--n_warmup_itrs", "1", "--n_total_itrs", "2", "--n_grad_accum_itrs", "1",
              "--n_save_every_itrs", "1", "--device", "cpu"]


class _KeptTrainers:
    """Within the block, every Trainer that trains is kept in ``seen``, and
    its optimizer state as training starts in ``states``."""

    def __enter__(self):
        from xvr_tpu_torch.train import Trainer

        self.seen, self.states, self.orig = [], [], Trainer.train

        def spy(tr, *a, **k):
            self.seen.append(tr)
            self.states.append({k: (v if isinstance(v, int) else {n: t.clone() for n, t in v.items()})
                                for k, v in tr.opt_state.items()})
            return self.orig(tr, *a, **k)

        Trainer.train = spy
        return self

    def __exit__(self, *exc):
        from xvr_tpu_torch.train import Trainer

        Trainer.train = self.orig


@pytest.mark.parametrize("masked", [False, True])
def test_train_then_restart_on_cpu(train_data, tmp_path, monkeypatch, masked, two_torch_threads):
    """``train --device cpu`` runs 2 steps through the shear-warp route and
    writes its checkpoints (the optimizer state in optax's layout, read by
    the JAX package's ``restore_into``); ``restart`` from the step-1
    checkpoint resumes at its iteration with the optimizer state it saved."""
    import flax.serialization

    from xvr_tpu.train.checkpoint import restore_into
    from xvr_tpu_torch.train import load_checkpoint

    monkeypatch.setenv("XVR_FORCE_SHEARWARP", "1")
    monkeypatch.setenv("XVR_LOG_DIR", str(tmp_path / "runs"))
    out = tmp_path / "out"
    mask = ["-m", str(train_data / "mask.nii.gz")] if masked else []
    with _KeptTrainers() as kept:
        assert main(["train", "-v", str(train_data / "volume.nii.gz"), *mask, "-o", str(out),
                     *TRAIN_ARGS]) == 0
    tr = kept.seen[0]
    assert tr.projectors[0][0].renderer == "trilinear_fast" and tr.labels == ((1,) if masked else None)
    assert sorted(p.name for p in out.glob("*.ckpt")) == ["0000.ckpt", "0001.ckpt", "0002.ckpt"]
    logged = [json.loads(line) for line in (out / "train_log.jsonl").read_text().splitlines()]
    assert [m["itr"] for m in logged] == [0, 1] and all(np.isfinite(m["loss"]) for m in logged)
    assert (tmp_path / "runs" / "xvr" / "xvr.jsonl").exists()

    ckpt = load_checkpoint(out / "0001.ckpt")
    assert ckpt["itr"] == 1 and ckpt["config"]["n_total_itrs"] == 2
    # the JAX package restores the port's optimizer state into optax's tree
    import optax
    from xvr_tpu.train import trainer as jtrainer

    params = jax.tree.map(jnp.asarray, ckpt["model_state_dict"])
    tx = optax.MultiSteps(optax.chain(optax.adaptive_grad_clip(0.01, eps=1e-3),
                                      optax.adam(jtrainer.warmup_cosine_schedule(1e-3, 1, 2))), 1)
    state = restore_into(tx.init(params), ckpt["optimizer_state_dict"])
    assert int(state.gradient_step) == 1
    flat = flax.serialization.to_state_dict(state)
    np.testing.assert_array_equal(
        np.asarray(flat["inner_opt_state"]["1"]["0"]["mu"]["params"]["Dense_1"]["bias"]),
        ckpt["optimizer_state_dict"]["inner_opt_state"]["1"]["0"]["mu"]["params"]["Dense_1"]["bias"])

    with _KeptTrainers() as kept:
        assert main(["restart", "-c", str(out / "0001.ckpt"), "--device", "cpu"]) == 0
    rt, st = kept.seen[0], kept.states[0]
    assert rt.start_itr == 1 and rt.config["reuse_optimizer"] is True
    saved = ckpt["optimizer_state_dict"]
    assert (st["gradient_step"], st["adam_count"], st["schedule_count"]) == (
        int(saved["gradient_step"]), int(saved["inner_opt_state"]["1"]["0"]["count"]),
        int(saved["inner_opt_state"]["1"]["1"]["count"]))
    from xvr_tpu_torch.state import to_flax_params

    for moment in ("mu", "nu"):
        got = to_flax_params(rt.model, st[moment])["params"]["Dense_0"]["kernel"]
        np.testing.assert_array_equal(
            got, saved["inner_opt_state"]["1"]["0"][moment]["params"]["Dense_0"]["kernel"])
    logged = [json.loads(line) for line in (out / "train_log.jsonl").read_text().splitlines()]
    assert [m["itr"] for m in logged] == [0, 1, 1] and np.isfinite(logged[-1]["loss"])


def test_train_refuses_a_mesh(train_data, tmp_path, monkeypatch, two_torch_threads):
    monkeypatch.setenv("XVR_LOG_DIR", str(tmp_path / "runs"))
    with pytest.raises(ValueError, match="--n_devices 2: a device mesh needs 2 CUDA devices"):
        main(["train", "-v", str(train_data / "volume.nii.gz"), "-o", str(tmp_path / "o"),
              *TRAIN_ARGS, "--n_devices", "2"])


# ---------------------------------------------------------------------------
# animate and dcm2nii
# ---------------------------------------------------------------------------


def test_animate_dcm2nii_surface_matches_click():
    """``animate`` has the JAX command's options (and ``--device``), and
    ``dcm2nii`` its two arguments."""
    from xvr_tpu.cli.commands.animate import animate as janimate
    from xvr_tpu.cli.commands.dcm2nii import dcm2nii as jdcm2nii

    mine = _command_surface(_subparsers(build_parser())["animate"])
    assert mine.pop("device") == dict(opts=["--device"], default="cuda", nargs=1, required=False,
                                      flag=False, choices=["cuda", "cpu"], range=None,
                                      category="Miscellaneous")
    assert mine == _click_surface(janimate)
    p = _subparsers(build_parser())["dcm2nii"]
    args = [(a.dest, a.nargs, a.required) for a in p._actions if not a.option_strings]
    assert args == [(n, None, spec["required"]) for n, spec in _click_surface(jdcm2nii).items()]


def test_animate_and_dcm2nii_commands(workdir, tmp_path, capsys):
    """``dcm2nii`` converts a series and says so; ``animate`` replays a
    ``register`` bundle, one frame per ``--skip`` poses, as a GIF where no
    video backend is installed."""
    import imageio.v3 as iio

    from test_torch_dcm2nii import _write_series
    from xvr_tpu_torch.io import load_nifti

    series = tmp_path / "series"
    series.mkdir()
    hu, _ = _write_series(series)
    out = tmp_path / "out" / "ct.nii.gz"
    assert main(["dcm2nii", str(series), str(out)]) == 0
    assert f"Converting {series} to {out}" in capsys.readouterr().out
    np.testing.assert_allclose(load_nifti(out)[0], hu, atol=1e-3)

    res = tmp_path / "results"
    assert main(["register", "fixed", str(workdir / "xray.dcm"), "-v", str(workdir / "ct.nii.gz"),
                 "-o", str(res), "--rot", "3.18", "0.0", "0.0", "--xyz", "0.0", "225.0", "0.0",
                 "--scales", "2", "--n_itrs", "5", "--max_restarts", "0", "--restart_seeds", "1",
                 "--verbose", "0", "--device", "cpu"]) == 0
    n = len(np.load(res / "xray" / "parameters.npz")["trajectory_params"])
    gif = tmp_path / "anim.gif"
    assert main(["animate", "-i", str(res / "xray"), "-o", str(gif), "--skip", "2", "--dpi", "24",
                 "--device", "cpu"]) == 0
    assert iio.imread(gif, index=None).shape[0] == len(range(0, n, 2))
