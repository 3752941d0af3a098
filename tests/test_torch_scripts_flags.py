"""The port's experiment scripts against the JAX package's (CPU).

``scripts/torch/{deepfluoro,ljubljana,femur}/{train,register,evaluate}/*.sh``
are the twins of ``scripts/{deepfluoro,ljubljana,femur}/**/*.sh``: the same
commands with ``xvr`` replaced by ``xvr-torch`` (the port's console entry,
``xvr_tpu_torch.cli.cli:main``), except the evaluate lines, which call
``python scripts/torch/evaluate.py -f <results> -s <csv> -d data``. Every
``xvr-torch`` line parses under the port's argparse CLI and every evaluate
line under the port's evaluate script, with the paths they name made to
exist. The JAX scripts' own evaluate lines pass ``--dataset``/``-o``, which
``scripts/evaluate.py`` does not take; the last test records that fault of
the reference files, which this repository keeps as they are.
"""

import collections
import importlib.util
import re
import sys
import tomllib
from pathlib import Path

import pytest

from xvr_tpu_torch.cli import cli as port_cli
from torch_threads import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
JAX_SCRIPTS = sorted(p for p in REPO.glob("scripts/*/*/*.sh") if p.parts[-4] == "scripts")
TWINS = sorted((REPO / "scripts" / "torch").glob("*/*/*.sh"))
# the reference's evaluate line -> its twin's, per script (the one change
# beside xvr -> xvr-torch)
EVALUATE_LINES = {
    f"{ds}/evaluate/{kind}.sh": (
        f"python scripts/evaluate.py results/{ds}/evaluate/{kind} --dataset {ds} "
        f"-o results/{ds}/evaluate/{kind}.csv",
        f"python scripts/torch/evaluate.py -f results/{ds}/evaluate/{kind} "
        f"-s results/{ds}/evaluate/{kind}.csv -d data",
    )
    for ds in ("deepfluoro", "ljubljana") for kind in ("finetuned", "foundation")
}


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load(REPO / "chip_smoke.py", "chip_smoke_flags")


def _commands(text):
    """Each command line of a shell script, as chip_smoke.py's phase 8 reads
    it (continuations joined, comments and blank lines dropped,
    whitespace-normalized)."""
    return SMOKE.shell_commands(text)


def _tokens(line):
    """shlex tokens with every shell variable set to a plain word, by
    chip_smoke.py's expansion."""
    return SMOKE.expand(line, collections.defaultdict(lambda: "X"))


def _make_paths(tokens, root: Path):
    """Create every path-like token under ``root`` (a file, or a directory
    where another token lies under it)."""
    paths = {t for t in tokens if not t.startswith("-") and ("/" in t or t.isupper())}
    for p in sorted(paths):
        target = root / p
        if any(q.startswith(p + "/") for q in paths):
            target.mkdir(parents=True, exist_ok=True)
        else:
            target.parent.mkdir(parents=True, exist_ok=True)
            target.touch()


def _lines_of(scripts, prefix):
    return [(sh, line) for sh in scripts for line in _commands(sh.read_text())
            if line.startswith(prefix)]


def _params(scripts, prefix):
    """pytest params (script, line), one per line that starts with ``prefix``."""
    out = []
    for sh, line in _lines_of(scripts, prefix):
        rel = str(sh.relative_to(REPO / "scripts"))
        out.append(pytest.param(sh, line, id=f"{rel}:{sum(p.id.startswith(rel) for p in out)}"))
    return out


def test_every_jax_script_has_its_twin():
    rel = lambda ps, root: sorted(str(p.relative_to(root)) for p in ps)  # noqa: E731
    assert len(JAX_SCRIPTS) == 19
    assert rel(TWINS, REPO / "scripts" / "torch") == rel(JAX_SCRIPTS, REPO / "scripts")


@pytest.mark.parametrize("sh", JAX_SCRIPTS, ids=lambda p: str(p.relative_to(REPO / "scripts")))
def test_twin_commands_are_the_jax_scripts(sh):
    rel = str(sh.relative_to(REPO / "scripts"))
    expected = []
    for line in _commands(sh.read_text()):
        if line.startswith("python scripts/evaluate.py"):
            assert line == EVALUATE_LINES[rel][0]
            line = EVALUATE_LINES[rel][1]
        expected.append(re.sub(r"^xvr ", "xvr-torch ", line))
    twin = REPO / "scripts" / "torch" / rel
    assert _commands(twin.read_text()) == expected
    assert twin.stat().st_mode == sh.stat().st_mode


@pytest.mark.parametrize("sh,line", _params(TWINS, "xvr-torch "))
def test_xvr_torch_lines_parse_under_the_port_cli(sh, line, tmp_path, monkeypatch):
    tokens = _tokens(line)
    _make_paths(tokens, tmp_path)
    monkeypatch.chdir(tmp_path)
    kw = vars(port_cli.build_parser().parse_args(tokens[1:]))
    assert kw["command"] == tokens[1] and kw["device"] == "cuda"
    for flag in (t for t in tokens if t.startswith("--")):
        assert kw[flag[2:]] is not None and kw[flag[2:]] is not False, f"{flag} was dropped"


@pytest.mark.parametrize("sh,line", _params(TWINS, "python scripts/torch/evaluate.py"))
def test_evaluate_lines_parse_under_the_port_script(sh, line, tmp_path, monkeypatch):
    tokens = _tokens(line)
    assert tokens[:2] == ["python", "scripts/torch/evaluate.py"]
    _make_paths(tokens[2:] + ["data/"], tmp_path)
    monkeypatch.chdir(tmp_path)
    ev = _load(REPO / "scripts" / "torch" / "evaluate.py", "torch_evaluate_flags")
    kw = ev.build_parser().parse_args(tokens[2:])
    assert (kw.filepath, kw.savepath, kw.data_root, kw.device) == (
        tokens[3], tokens[5], "data", "cuda")


def test_console_entry_point_is_the_port_cli():
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts["xvr"] == "xvr_tpu.cli.cli:cli"
    module, attr = scripts["xvr-torch"].split(":")
    assert module == port_cli.__name__ and getattr(port_cli, attr) is port_cli.main
    with pytest.raises(SystemExit) as exc:
        port_cli.main(["--version"])
    assert exc.value.code == 0


def test_reference_evaluate_lines_fail_under_their_parser(tmp_path, monkeypatch):
    """The fault of the reference files: scripts/evaluate.py takes -f/-s/-d,
    so its callers' --dataset/-o lines stop with "No such option"."""
    from click.testing import CliRunner

    ev = _load(REPO / "scripts" / "evaluate.py", "jax_evaluate_flags")
    lines = _lines_of(JAX_SCRIPTS, "python scripts/evaluate.py")
    assert sorted(str(sh.relative_to(REPO / "scripts")) for sh, _ in lines) == sorted(EVALUATE_LINES)
    for _, line in lines:
        tokens = _tokens(line)
        _make_paths(tokens[2:], tmp_path)
        monkeypatch.chdir(tmp_path)
        r = CliRunner().invoke(ev.main, tokens[2:])
        assert r.exit_code == 2 and "No such option" in r.output, r.output
