"""The port's synthetic volumes and profiling hooks (CPU).

``load_example_ct`` and ``make_test_volume`` give the JAX package's grids
and affines exactly; ``utils.profiling`` reads ``XVR_PROFILE_DIR`` and
writes a torch.profiler trace.
"""

import numpy as np
import pytest
import torch

from xvr_tpu.render import load_example_ct as j_example, make_test_volume as j_test_volume
from xvr_tpu_torch.render import load_example_ct, make_test_volume
from xvr_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two torch threads per test: the suite runs several workers on one
    machine, and each worker's torch would otherwise start a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["cube", "sphere", "gradient", "random"])
def test_make_test_volume_matches_jax(kind):
    ours, theirs = make_test_volume(20, spacing=1.5, kind=kind, device="cpu"), j_test_volume(20, 1.5, kind)
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(theirs.data))
    np.testing.assert_array_equal(ours.affine.numpy(), np.asarray(theirs.affine))
    assert ours.orientation == theirs.orientation and ours.mask is None
    with pytest.raises(ValueError):
        make_test_volume(8, kind="torus", device="cpu")


def test_load_example_ct_matches_jax():
    ours, theirs = load_example_ct("PA", n=40, device="cpu"), j_example("PA", n=40)
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(theirs.data))
    np.testing.assert_array_equal(ours.affine.numpy(), np.asarray(theirs.affine))
    assert ours.orientation == "PA"
    np.testing.assert_allclose(ours.center.numpy(), np.zeros(3), atol=1e-6)


def test_profiling_hooks(tmp_path, monkeypatch):
    monkeypatch.delenv("XVR_PROFILE_DIR", raising=False)
    assert profiling.maybe_trace_dir() is None
    monkeypatch.setenv("XVR_PROFILE_DIR", str(tmp_path / "trace"))
    assert profiling.maybe_trace_dir() == str(tmp_path / "trace")
    prof = profiling.start_trace(profiling.maybe_trace_dir())
    with profiling.annotate("xvr_step"):
        torch.ones(8).sum()
    out = profiling.stop_trace(prof)
    assert out.exists() and "xvr_step" in out.read_text()
