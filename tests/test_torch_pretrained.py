"""ImageNet backbone grafting of the port against the JAX package's (CPU).

A synthetic torchvision-format ``state_dict`` (tests/test_models.py's
construction; nothing is downloaded) grafts into the port's PoseRegressor
and into the JAX package's parameter tree: the stem's summed RGB filters,
every convolution, the BatchNorm statistics folded into the GroupNorm
affine, and the downsample projections land in the same places, to float32
round-off (rtol 1e-6); the heads keep their initialization. The weights are
found the same way (``weights_path``, ``$XVR_PRETRAINED_DIR``, the torch hub
cache under ``$HOME``).
"""

import jax
import numpy as np
import pytest
import torch

from xvr_tpu.models.pretrained import find_imagenet_weights as j_find
from xvr_tpu.models.pretrained import load_imagenet_backbone as j_load
from xvr_tpu_torch.models import PoseRegressor
from xvr_tpu_torch.models.pretrained import find_imagenet_weights, load_imagenet_backbone
from xvr_tpu_torch.state import to_flax_params
from torch_threads import two_torch_threads  # noqa: F401


STAGES = {"resnet18": [2, 2, 2, 2], "resnet34": [3, 4, 6, 3]}


def _torchvision_sd(model_name, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32))

    def bn(c, prefix, sd):
        sd[f"{prefix}.weight"] = t(c)
        sd[f"{prefix}.bias"] = t(c)
        sd[f"{prefix}.running_mean"] = t(c)
        sd[f"{prefix}.running_var"] = torch.abs(t(c)) + 0.5

    sd = {"conv1.weight": t(64, 3, 7, 7)}
    bn(64, "bn1", sd)
    chans = [64, 128, 256, 512]
    for i, (c, size) in enumerate(zip(chans, STAGES[model_name])):
        cin = chans[i - 1] if i else 64
        for j in range(size):
            p = f"layer{i + 1}.{j}"
            sd[f"{p}.conv1.weight"] = t(c, cin if j == 0 else c, 3, 3)
            bn(c, f"{p}.bn1", sd)
            sd[f"{p}.conv2.weight"] = t(c, c, 3, 3)
            bn(c, f"{p}.bn2", sd)
            if j == 0 and i > 0:
                sd[f"{p}.downsample.0.weight"] = t(c, cin, 1, 1)
                bn(c, f"{p}.downsample.1", sd)
    sd["fc.weight"] = t(1000, 512)  # the classifier, which the graft leaves out
    return sd


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("model_name", ["resnet18", "resnet34"])
def test_graft_matches_jax(tmp_path, model_name):
    path = tmp_path / f"{model_name}.pth"
    torch.save(_torchvision_sd(model_name), path)
    model = PoseRegressor(model_name)
    heads = {k: v.clone() for k, v in model.state_dict().items() if "head" in k}
    params = to_flax_params(model)  # the JAX side starts from the same weights
    model, ok = load_imagenet_backbone(model, model_name, weights_path=path)
    jparams, jok = j_load(jax.tree.map(np.asarray, params), model_name, weights_path=path)
    assert ok and jok
    ours, theirs = _flat(to_flax_params(model)), _flat(jparams)
    assert sorted(ours) == sorted(theirs)
    for k, ref in theirs.items():
        np.testing.assert_allclose(ours[k], ref, rtol=1e-6, atol=1e-7, err_msg=str(k))
    for k, v in heads.items():
        assert torch.equal(model.state_dict()[k], v)
    # the graft changed the backbone, and the model runs
    assert not np.allclose(ours[("params", "ResNet_0", "Conv_0", "kernel")],
                           _flat(params)[("params", "ResNet_0", "Conv_0", "kernel")])
    rot, xyz = model(torch.zeros((1, 1, 32, 32)))
    assert torch.isfinite(rot).all() and torch.isfinite(xyz).all()


def test_weights_lookup_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("XVR_PRETRAINED_DIR", raising=False)
    assert find_imagenet_weights("resnet18") is None and j_find("resnet18") is None
    model = PoseRegressor("resnet18")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    same, ok = load_imagenet_backbone(model, "resnet18", weights_path=tmp_path / "nope.pth")
    assert not ok and all(torch.equal(same.state_dict()[k], v) for k, v in before.items())
    assert load_imagenet_backbone(model, "vit", weights_path=tmp_path / "nope.pth")[1] is False

    hub = tmp_path / "home" / ".cache" / "torch" / "hub" / "checkpoints"
    hub.mkdir(parents=True)
    (hub / "resnet34-b627a593.pth").write_bytes(b"")
    assert find_imagenet_weights("resnet34") == j_find("resnet34") == hub / "resnet34-b627a593.pth"
    env = tmp_path / "pretrained"
    env.mkdir()
    (env / "resnet34.pth").write_bytes(b"")
    monkeypatch.setenv("XVR_PRETRAINED_DIR", str(env))
    assert find_imagenet_weights("resnet34") == j_find("resnet34") == env / "resnet34.pth"
    explicit = tmp_path / "mine.pth"
    explicit.write_bytes(b"")
    assert find_imagenet_weights("resnet34", explicit) == j_find("resnet34", explicit) == explicit
