"""The port's checkpoints against the JAX package's (CPU).

The port reads and writes flax msgpack with its own codec
(``xvr_tpu_torch.io.msgpack``); here it is held byte for byte against the
installed ``msgpack`` and ``flax.serialization``. A checkpoint that either
package writes loads in the other and predicts the same pose: the weights
cross exactly (float32 in both), and the two forwards agree to 1e-4 of the
pose matrix's largest entry (float32 sums in different orders;
tests/test_torch_models.py).
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import msgpack as pymsgpack
import numpy as np
import optax
import pytest
import torch

from xvr_tpu.models import load_model as j_load_model
from xvr_tpu.train.checkpoint import latest_checkpoint as j_latest_checkpoint
from xvr_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from xvr_tpu_torch.io import msgpack
from xvr_tpu_torch.models import PoseRegressor, init_pose_regressor, load_model
from xvr_tpu_torch.state import to_flax_params
from xvr_tpu_torch.train import latest_checkpoint, load_checkpoint, save_checkpoint

POSE_RTOL = 1e-4
CONFIG = dict(model_name="resnet18", parameterization="quaternion_adjugate", convention="ZXY",
              norm_layer="groupnorm", unit_conversion_factor=1000.0, height=32,
              delx=8.0, sdd=400.0, orientation="AP")


@pytest.mark.parametrize("obj", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -(2**31), -(2**31) - 1, -(2**63),
    0.5, -1e300, float("inf"), True, False, None,
    "", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000,
    b"", b"x" * 255, b"y" * 256, b"z" * 70000,
    list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {"nested": {"a": [1, {"b": None}], "c": (1.5, "x")}},
])
def test_codec_matches_msgpack(obj):
    packed = pymsgpack.packb(obj, use_bin_type=True, strict_types=False)
    assert msgpack.packb(obj) == packed
    assert msgpack.unpackb(packed) == pymsgpack.unpackb(packed, raw=False, strict_map_key=False)


def _same_tree(a, b):
    """Equal trees; bf16 leaves (torch on the port's side, ml_dtypes in
    flax's) compared through float32."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b)
        for k in b:
            _same_tree(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == torch.bfloat16 and b.dtype.name == "bfloat16"
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
    elif isinstance(b, (np.ndarray, np.generic)):
        assert type(a) is type(b) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


def test_jax_checkpoint_bytes_round_trip(tmp_path):
    """An xvr_tpu checkpoint with an optax Adam state, a bf16 leaf and NumPy
    scalars decodes like flax's msgpack_restore and encodes back to the
    same bytes."""
    params = {"params": {"Dense_0": {"kernel": jnp.arange(12.0).reshape(3, 4),
                                     "bias": jnp.zeros(4)}}}
    opt_state = {
        "adam": optax.adam(1e-3).init(params),
        "ema": jnp.linspace(-2, 3, 7, dtype=jnp.bfloat16),
        "scale": np.float32(2.5),
        "step": np.int64(-7),
        "flag": np.bool_(True),
    }
    path = j_save_checkpoint(tmp_path / "a.ckpt", params, opt_state, 123, 4,
                             {**CONFIG, "scales": (1, 2), "path": tmp_path})
    raw = path.read_bytes()
    ours = load_checkpoint(path)
    _same_tree(ours, flax.serialization.msgpack_restore(raw))
    assert msgpack.serialize(ours) == raw


def test_chunked_arrays_match_flax(monkeypatch):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(100, dtype=np.float32).reshape(4, 25),
            "half": np.asarray(jnp.arange(70, dtype=jnp.bfloat16)),
            "small": np.ones(3, np.int32)}
    raw = flax.serialization.msgpack_serialize(tree)
    ours = {"big": tree["big"], "half": torch.arange(70, dtype=torch.bfloat16),
            "small": tree["small"]}
    assert msgpack.serialize(ours) == raw
    _same_tree(msgpack.restore(raw), flax.serialization.msgpack_restore(raw))


def _seeded_port_model(seed=0, **cfg):
    cfg = {**CONFIG, **cfg}
    m = PoseRegressor(cfg["model_name"], cfg["parameterization"], cfg["convention"],
                      cfg["norm_layer"], cfg.get("unit_conversion_factor", 1.0))
    init_pose_regressor(m, torch.Generator().manual_seed(seed))
    return m.eval()


def _x(seed=1, n=32):
    return np.random.default_rng(seed).normal(size=(2, 1, n, n)).astype(np.float32)


def _assert_same_pose(port_pose, jax_pose):
    got, ref = port_pose.matrix.detach().numpy(), np.asarray(jax_pose.matrix)
    np.testing.assert_allclose(got, ref, rtol=0, atol=POSE_RTOL * np.abs(ref).max())


def test_jax_checkpoint_predicts_jax_pose_in_port(tmp_path):
    params = jax.tree.map(jnp.asarray, to_flax_params(_seeded_port_model(seed=3)))
    path = j_save_checkpoint(tmp_path / "jax.ckpt", params, optax.adam(1e-3).init(params),
                             10, 1, CONFIG)
    jmodel, jparams, jconfig = j_load_model(path)
    model, tparams, config = load_model(path, device="cpu")
    assert config == jconfig
    x = _x()
    _assert_same_pose(model.predict_pose(tparams, torch.from_numpy(x)),
                      jmodel.predict_pose(jparams, jnp.asarray(x)))


def test_port_checkpoint_predicts_port_pose_in_jax(tmp_path):
    model = _seeded_port_model(seed=4)
    path = save_checkpoint(tmp_path / "port.ckpt", to_flax_params(model), {}, 0, 1, CONFIG)
    jmodel, jparams, _, jdate = j_load_model(path, meta=True)
    _, _, _, date = load_model(path, meta=True, device="cpu")
    assert date == jdate
    x = _x(2)
    with torch.no_grad():
        pose = model.predict_pose(dict(model.state_dict()), torch.from_numpy(x))
    _assert_same_pose(pose, jmodel.predict_pose(jparams, jnp.asarray(x)))


def test_unit_conversion_factor_defaults_to_one(tmp_path):
    """A config without unit_conversion_factor reads 1.0, as in the JAX
    package's load_model (the class default is 1000)."""
    cfg = {k: v for k, v in CONFIG.items() if k != "unit_conversion_factor"}
    path = save_checkpoint(tmp_path / "m.ckpt", to_flax_params(_seeded_port_model()), {}, 0, 1, cfg)
    model, _, _ = load_model(path, device="cpu")
    jmodel, _, _ = j_load_model(path)
    assert model.unit_conversion_factor == jmodel.unit_conversion_factor == 1.0


def test_latest_checkpoint_matches_jax(tmp_path):
    assert latest_checkpoint(tmp_path) is None and j_latest_checkpoint(tmp_path) is None
    for i, name in enumerate(["b.ckpt", "a.pth", "c.ckpt"]):
        (tmp_path / name).write_bytes(b"")
        os.utime(tmp_path / name, (1e9 + i, 1e9 + (2 - i) if name != "a.pth" else 2e9))
    assert latest_checkpoint(tmp_path) == j_latest_checkpoint(tmp_path) == tmp_path / "a.pth"
    assert latest_checkpoint(tmp_path / "b.ckpt") == tmp_path / "b.ckpt"
