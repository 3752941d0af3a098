"""ImageNet backbone initialization from torchvision-format ``state_dict``
files: counterpart of ``xvr_tpu.models.pretrained``.

Nothing is downloaded: the weights come from a local file (``weights_path``,
``$XVR_PRETRAINED_DIR``, or the torch hub cache). The graft follows the JAX
package's:

* the stem convolution collapses RGB to the single X-ray channel by summing
  the RGB filters (timm's ``in_chans=1`` adaptation);
* each BatchNorm's running statistics are folded into its affine
  (scale = w / sqrt(var + eps), bias = b - mean * scale), which becomes the
  GroupNorm's affine;
* the pose heads keep their initialization.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

_STAGES = {
    "resnet18": ([2, 2, 2, 2], "basic"),
    "resnet34": ([3, 4, 6, 3], "basic"),
    "resnet50": ([3, 4, 6, 3], "bottleneck"),
    "resnet101": ([3, 4, 23, 3], "bottleneck"),
}

_HUB_NAMES = {
    "resnet18": "resnet18-f37072fd.pth",
    "resnet34": "resnet34-b627a593.pth",
    "resnet50": "resnet50-0676ba61.pth",
    "resnet101": "resnet101-63fe2227.pth",
}


def find_imagenet_weights(model_name: str, weights_path=None) -> Path | None:
    """Locate a torchvision-format state_dict for ``model_name`` on disk."""
    candidates = []
    if weights_path is not None:
        candidates.append(Path(weights_path))
    env = os.environ.get("XVR_PRETRAINED_DIR")
    if env:
        candidates.append(Path(env) / f"{model_name}.pth")
        candidates.append(Path(env) / _HUB_NAMES.get(model_name, f"{model_name}.pth"))
    hub = Path.home() / ".cache" / "torch" / "hub" / "checkpoints"
    candidates.append(hub / _HUB_NAMES.get(model_name, f"{model_name}.pth"))
    for c in candidates:
        if c.is_file():
            return c
    return None


def _folded_affine(sd, prefix: str, eps: float = 1e-5):
    w, b = sd[f"{prefix}.weight"].float(), sd[f"{prefix}.bias"].float()
    rm, rv = sd[f"{prefix}.running_mean"].float(), sd[f"{prefix}.running_var"].float()
    scale = w / torch.sqrt(rv + eps)
    return scale, b - rm * scale


def load_imagenet_backbone(model, model_name: str, weights_path=None):
    """Graft ImageNet weights into a :class:`~xvr_tpu_torch.models.PoseRegressor`
    (in place). -> (model, loaded: bool); without a weights file the model
    is returned unchanged with ``loaded=False``."""
    if model_name not in _STAGES:
        return model, False
    path = find_imagenet_weights(model_name, weights_path)
    if path is None:
        return model, False
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    net = model.backbone

    def put(param, value):
        param.copy_(value.to(dtype=param.dtype, device=param.device))

    def put_norm(norm, prefix):
        scale, bias = _folded_affine(sd, prefix)
        put(norm.weight, scale)
        put(norm.bias, bias)

    with torch.no_grad():
        put(net.conv1.weight, sd["conv1.weight"].float().sum(dim=1, keepdim=True))
        put_norm(net.norm1, "bn1")
        stages, kind = _STAGES[model_name]
        n_convs = 2 if kind == "basic" else 3
        k = 0
        for i, size in enumerate(stages):
            for j in range(size):
                blk, tp = net.blocks[k], f"layer{i + 1}.{j}"
                for c in range(n_convs):
                    put(blk.convs[c].weight, sd[f"{tp}.conv{c + 1}.weight"].float())
                    put_norm(blk.norms[c], f"{tp}.bn{c + 1}")
                if len(blk.convs) > n_convs:
                    put(blk.convs[n_convs].weight, sd[f"{tp}.downsample.0.weight"].float())
                    put_norm(blk.norms[n_convs], f"{tp}.downsample.1")
                k += 1
    return model, True
