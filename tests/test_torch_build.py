"""Where the port's kernels come from and where they are built: the sources
travel with the package (MANIFEST.in), and the library goes to
$XVR_TORCH_BUILD_DIR, else the repository's build/, else the user cache.
Nothing here compiles or needs a GPU."""

import fnmatch
import os
from pathlib import Path

from xvr_tpu_torch.render import _cuda
from torch_threads import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _manifest_patterns():
    """(directory, file patterns) of each recursive-include line."""
    out = []
    for line in (REPO / "MANIFEST.in").read_text().splitlines():
        words = line.split()
        if words and words[0] == "recursive-include":
            out.append((words[1], words[2:]))
    return out


def test_manifest_ships_every_kernel_source():
    patterns = _manifest_patterns()
    assert patterns
    for src in _cuda.SOURCES:
        rel = src.relative_to(REPO)
        assert any(
            rel.parent.as_posix().startswith(d) and any(fnmatch.fnmatch(rel.name, p) for p in pats)
            for d, pats in patterns
        ), rel


def test_build_dir_takes_the_variable_first(monkeypatch, tmp_path):
    monkeypatch.setenv(_cuda.BUILD_ENV, str(tmp_path / "kernels"))
    assert _cuda.build_dir() == tmp_path / "kernels"


def test_build_dir_is_the_repository_build_when_writable(monkeypatch, tmp_path):
    monkeypatch.delenv(_cuda.BUILD_ENV, raising=False)
    assert _cuda.build_dir() == REPO / "build"  # a checkout: build/ at its root
    monkeypatch.setattr(_cuda, "REPO_BUILD_DIR", tmp_path / "repo" / "build")
    assert _cuda.build_dir() == tmp_path / "repo" / "build"  # made on the first build


def test_build_dir_falls_back_to_the_user_cache(monkeypatch, tmp_path):
    """A read-only repository (an installed package in site-packages) builds
    into ~/.cache/xvr_tpu_torch/build."""
    monkeypatch.delenv(_cuda.BUILD_ENV, raising=False)
    repo_build = tmp_path / "site-packages" / "build"
    monkeypatch.setattr(_cuda, "REPO_BUILD_DIR", repo_build)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    real_access = os.access
    read_only = tmp_path / "site-packages"

    def access(path, mode):
        p = Path(path)
        if p == read_only or read_only in p.parents:
            return False
        return real_access(path, mode)

    monkeypatch.setattr(os, "access", access)
    (tmp_path / "site-packages").mkdir()
    assert _cuda.build_dir() == tmp_path / "home" / ".cache" / "xvr_tpu_torch" / "build"
    # the variable still wins
    monkeypatch.setenv(_cuda.BUILD_ENV, str(tmp_path / "elsewhere"))
    assert _cuda.build_dir() == tmp_path / "elsewhere"
