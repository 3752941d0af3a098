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
from torch_threads import two_torch_threads  # noqa: F401

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


# ---------------------------------------------------------------------------
# optimizer state across packages (the trainer's restart)
# ---------------------------------------------------------------------------

TRAIN_RANGES = dict(alphamin=165.0, alphamax=195.0, betamin=-15.0, betamax=15.0,
                    gammamin=-15.0, gammamax=15.0, txmin=-10.0, txmax=10.0,
                    tymin=150.0, tymax=250.0, tzmin=-10.0, tzmax=10.0)


@pytest.fixture(scope="module")
def ct_file(tmp_path_factory):
    from xvr_tpu.io import save_nifti

    d = tmp_path_factory.mktemp("ct")
    n, c = 16, 7.5
    idx = np.arange(n)
    X, Y, Z = np.meshgrid(idx, idx, idx, indexing="ij")
    hu = np.where((X - c) ** 2 + (Y - c) ** 2 + (Z - c) ** 2 <= 25.0, 500.0, -1000.0)
    aff = np.eye(4) * 4.0
    aff[3, 3] = 1.0
    aff[:3, 3] = -c * 4.0
    save_nifti(d / "ct.nii.gz", hu.astype(np.float32), aff)
    return d / "ct.nii.gz"


def _trainer_kwargs(ct_file, tmp_path, every_k):
    return dict(volpath=ct_file, maskpath=None, outpath=tmp_path / "out", sdd=400.0, height=32,
                delx=4.0, model_name="resnet18", batch_size=2, lr=1e-2, n_total_itrs=16,
                n_warmup_itrs=4, n_grad_accum_itrs=every_k, n_save_every_itrs=100,
                **TRAIN_RANGES)


def _optax_tx(every_k, lr=1e-2, warmup=4, total=16):
    from xvr_tpu.train.schedule import warmup_cosine_schedule as j_schedule

    inner = optax.chain(optax.adaptive_grad_clip(0.01, eps=1e-3),
                        optax.adam(j_schedule(lr, warmup / every_k, total / every_k)))
    return optax.MultiSteps(inner, every_k_schedule=every_k)


def _seeded_grads(params_tree, rng):
    return jax.tree.map(lambda p: (1e-2 * rng.normal(size=p.shape)).astype(np.float32), params_tree)


def _flat_tree(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_tree(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def _assert_same_tree(got, ref):
    got, ref = _flat_tree(got), _flat_tree(ref)
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, rtol=1e-6, atol=1e-6 * np.abs(r).max(), err_msg=str(k))


@pytest.mark.parametrize("every_k", [1, 2])
def test_jax_optimizer_state_resumes_in_port_trainer(ct_file, tmp_path, every_k):
    """A JAX checkpoint (weights and optax state after 3 gradients) restores
    into the port's Trainer(reuse_optimizer=True) with its iteration and
    model number; the next update on equal gradients equals optax's
    (rtol 1e-6, atol 1e-6 of each leaf's largest magnitude)."""
    from xvr_tpu_torch.state import from_flax_params
    from xvr_tpu_torch.train import Trainer

    rng = np.random.default_rng(0)
    params = jax.tree.map(jnp.asarray, to_flax_params(_seeded_port_model(seed=5)))
    tx = _optax_tx(every_k)
    update = jax.jit(tx.update)
    state = tx.init(params)
    for _ in range(3):
        upd, state = update(_seeded_grads(params, rng), state, params)
        params = optax.apply_updates(params, upd)
    cfg = _trainer_kwargs(ct_file, tmp_path, every_k)
    path = j_save_checkpoint(tmp_path / "jax.ckpt", params, state, 3, 2,
                             {k: str(v) if hasattr(v, "is_file") else v for k, v in cfg.items()})
    tr = Trainer(**cfg, ckptpath=path, reuse_optimizer=True, device="cpu")
    assert (tr.start_itr, tr.model_number) == (3, 2)
    _assert_same_tree(to_flax_params(tr.model), jax.device_get(params))
    _assert_same_tree(tr.tx.state_dict(tr.opt_state, lambda d: to_flax_params(tr.model, d)),
                      flax.serialization.to_state_dict(jax.device_get(state)))

    g = _seeded_grads(params, rng)
    upd, state = update(g, state, params)
    params = optax.apply_updates(params, upd)
    tr.tx.step(tr.params, from_flax_params(g), tr.opt_state)
    _assert_same_tree(to_flax_params(tr.model), jax.device_get(params))


def test_port_optimizer_state_restores_in_jax(ct_file, tmp_path):
    """A checkpoint of the port's Trainer restores in the JAX package's
    ``restore_into(opt_state, ...)``; the next update on equal gradients is
    the port's."""
    from xvr_tpu.train.checkpoint import load_checkpoint as j_load_checkpoint
    from xvr_tpu.train.checkpoint import restore_into
    from xvr_tpu_torch.state import from_flax_params
    from xvr_tpu_torch.train import Trainer

    rng = np.random.default_rng(1)
    tr = Trainer(**_trainer_kwargs(ct_file, tmp_path, 2), device="cpu")
    tree = to_flax_params(tr.model)
    for _ in range(5):
        tr.tx.step(tr.params, from_flax_params(_seeded_grads(tree, rng)), tr.opt_state)
    tr._checkpoint(5)
    ckpt = j_load_checkpoint(tmp_path / "out" / "0000.ckpt")
    params = restore_into(jax.tree.map(jnp.asarray, tree), ckpt["model_state_dict"])
    tx = _optax_tx(2)
    state = restore_into(tx.init(params), ckpt["optimizer_state_dict"])
    assert int(state.mini_step) == 1 and int(state.gradient_step) == 2
    g = _seeded_grads(tree, rng)
    upd, state = jax.jit(tx.update)(g, state, params)
    params = optax.apply_updates(params, upd)
    tr.tx.step(tr.params, from_flax_params(g), tr.opt_state)
    _assert_same_tree(to_flax_params(tr.model), jax.device_get(params))
    _assert_same_tree(tr.tx.state_dict(tr.opt_state, lambda d: to_flax_params(tr.model, d)),
                      flax.serialization.to_state_dict(jax.device_get(state)))


def test_restore_into_matches_jax():
    """restore_into rebuilds a template's structure (dicts, lists, tuples,
    namedtuples; extra state keys dropped) from a raw state dict, leaf for
    leaf as flax's from_state_dict does on the same NumPy arrays, and refuses
    a state that lacks a template key or has the wrong length."""
    from xvr_tpu.train.checkpoint import restore_into as j_restore_into
    from xvr_tpu_torch.train import restore_into

    rng = np.random.default_rng(12)
    arr = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    template = {"params": {"conv": {"kernel": arr(3, 3), "bias": arr(3)}, "dense": [arr(2), arr(4)]},
                "state": (optax.ScaleByAdamState(count=np.zeros((), np.int32), mu=arr(2), nu=arr(2)),
                          optax.EmptyState()),
                "step": 0}
    state = flax.serialization.to_state_dict(jax.tree_util.tree_map(lambda x: x * 0 + 1, template))
    state["params"]["extra"] = arr(5)  # keys the template lacks are dropped
    state["step"] = 7
    got, ref = restore_into(template, state), j_restore_into(template, state)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref)
    for g, r in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        assert np.array_equal(np.asarray(g), np.asarray(r))
    assert got["step"] == 7 and "extra" not in got["params"]
    assert isinstance(got["state"][0], optax.ScaleByAdamState)
    for bad in ({"params": state["params"]}, {**state, "params": {**state["params"], "dense": {"0": 1}}}):
        with pytest.raises(ValueError):
            restore_into(template, bad)
        with pytest.raises(ValueError):
            j_restore_into(template, bad)
