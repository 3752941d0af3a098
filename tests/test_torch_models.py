"""Parity of the port's pose-regression CNN with the JAX package (CPU).

One flax parameter tree, drawn from a seed with NumPy (LeCun-scaled kernels,
norm scales and biases away from 1 and 0), drives ``xvr_tpu``'s flax
``PoseRegressor`` and, through ``from_flax_params``, the port's ``torch.nn``
one, on the same NumPy input. Features and (rot, xyz) agree to 1e-4 of their
largest magnitude: both sum the convolutions in float32, in different
orders. bf16 compute agrees to 3e-2 (a few bf16 roundings, 2^-8 each, land
differently). The configurations cover basic and bottleneck blocks, both
norms, and even and odd inputs (flax's "SAME" padding of the stride-2
convolutions differs between them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvr_tpu.models import PoseRegressor as JPoseRegressor
from xvr_tpu.models import create_backbone as j_create_backbone
from xvr_tpu.models import init_pose_regressor as j_init_pose_regressor
from xvr_tpu_torch.models import PoseRegressor, create_backbone
from xvr_tpu_torch.models.resnet import _same_pads, make_norm
from xvr_tpu_torch.state import from_flax_params, to_flax_params
from torch_threads import two_torch_threads  # noqa: F401

FEATURE_RTOL = 1e-4


def seeded_tree(model_name, norm_layer, parameterization="quaternion_adjugate", seed=0):
    """A flax PoseRegressor tree with the JAX package's structure and
    shapes, filled from ``seed``: kernels ~ N(0, 1/fan_in), norm scales
    1 + N(0, 0.1), biases N(0, 0.1)."""
    model = JPoseRegressor(model_name=model_name, norm_layer=norm_layer,
                           parameterization=parameterization)
    shapes = jax.eval_shape(lambda: j_init_pose_regressor(model, jax.random.PRNGKey(0), 32))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0.0, fan_in**-0.5, leaf.shape).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + rng.normal(0.0, 0.1, leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_model(tree, model_name, norm_layer, **kw):
    m = PoseRegressor(model_name, norm_layer=norm_layer, **kw)
    m.load_state_dict(from_flax_params(tree))
    return m.eval()


def _close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rtol, err


@pytest.mark.parametrize("model_name,norm_layer,size", [
    ("resnet18", "groupnorm", 64),
    ("resnet18", "layernorm", 33),
    ("resnet34", "groupnorm", 33),
    ("resnet50", "groupnorm", 33),
    ("resnet50", "layernorm", 64),
])
def test_features_and_heads_match_jax(model_name, norm_layer, size):
    tree = seeded_tree(model_name, norm_layer, seed=size)
    x = np.random.default_rng(1).normal(size=(2, 1, size, size)).astype(np.float32)
    jback = j_create_backbone(model_name, norm_layer)
    jfeat = jax.jit(jback.apply)({"params": tree["params"]["ResNet_0"]},
                                 jnp.asarray(x.transpose(0, 2, 3, 1)))
    jrot, jxyz = jax.jit(JPoseRegressor(model_name=model_name, norm_layer=norm_layer).apply)(
        tree, jnp.asarray(x))
    m = _port_model(tree, model_name, norm_layer)
    with torch.no_grad():
        feat = m.backbone(torch.from_numpy(x))
        rot, xyz = m(torch.from_numpy(x))
    _close(feat, jfeat, FEATURE_RTOL)
    _close(rot, jrot, FEATURE_RTOL)
    _close(xyz, jxyz, FEATURE_RTOL)


def test_bfloat16_compute_matches_jax():
    tree = seeded_tree("resnet18", "groupnorm", seed=5)
    x = np.random.default_rng(2).normal(size=(2, 1, 64, 64)).astype(np.float32)
    jfeat = jax.jit(j_create_backbone("resnet18", compute_dtype="bfloat16").apply)(
        {"params": tree["params"]["ResNet_0"]}, jnp.asarray(x.transpose(0, 2, 3, 1)))
    m = _port_model(tree, "resnet18", "groupnorm", compute_dtype="bfloat16")
    assert all(p.dtype == torch.float32 for p in m.parameters())
    with torch.no_grad():
        feat = m.backbone(torch.from_numpy(x))
    assert feat.dtype == torch.float32
    _close(feat, jfeat, 3e-2)


def test_flax_tree_round_trip_and_names():
    """from_flax_params then to_flax_params gives the tree back bit for bit,
    with flax's own names and nesting (the JAX package's init)."""
    for model_name, norm_layer in (("resnet18", "groupnorm"), ("resnet50", "layernorm")):
        tree = seeded_tree(model_name, norm_layer, seed=3)
        back = to_flax_params(_port_model(tree, model_name, norm_layer))
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            assert a.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("size,k,s,pads", [
    (64, 3, 2, (0, 1)), (33, 3, 2, (1, 1)), (64, 1, 2, (0, 0)), (33, 1, 2, (0, 0)),
    (16, 3, 1, (1, 1)), (7, 3, 2, (1, 1)),
])
def test_same_padding_is_flax(size, k, s, pads):
    """flax pads a SAME convolution by (total // 2, total - total // 2)."""
    assert _same_pads(size, k, s) == pads
    kernel = jnp.ones((k, k, 1, 1))
    out = jax.lax.conv_general_dilated(jnp.ones((1, size, size, 1)), kernel, (s, s), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"))
    lo, hi = pads
    ref = jax.lax.conv_general_dilated(jnp.ones((1, size, size, 1)), kernel, (s, s),
                                       [(lo, hi), (lo, hi)],
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_norms_follow_flax():
    gn = make_norm("groupnorm", 48)
    assert gn.num_groups == 16 and gn.eps == 1e-6
    assert make_norm("groupnorm", 64).num_groups == 32
    with pytest.raises(ValueError, match="Unsupported norm_layer"):
        make_norm("batchnorm", 64)
    with pytest.raises(ValueError, match="Unknown model_name"):
        create_backbone("convnext_tiny")


@pytest.mark.parametrize("parameterization,n", [
    ("quaternion_adjugate", 10), ("euler_angles", 3), ("rotation_6d", 6),
])
def test_regressor_heads_and_decode(parameterization, n):
    m = PoseRegressor("resnet18", parameterization=parameterization)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 1, 32, 32)).astype(np.float32))
    with torch.no_grad():
        rot, xyz = m(x)
        pose = m.predict_pose(dict(m.state_dict()), x)
    assert rot.shape == (2, n) and xyz.shape == (2, 3)
    R = pose.R.numpy()
    np.testing.assert_allclose(R @ np.swapaxes(R, -1, -2), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-4)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-4)
