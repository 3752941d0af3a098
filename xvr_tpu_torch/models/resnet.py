"""ResNet backbones for pose regression, in ``torch.nn`` on NCHW tensors.

Counterpart of ``xvr_tpu.models.resnet`` (flax), layer for layer, so that
one set of weights gives the same features in both packages
(:func:`xvr_tpu_torch.state.from_flax_params`). What that takes:

* flax's ``padding="SAME"``: a 3x3 stride-2 convolution pads (0, 1) on an
  even input and (1, 1) on an odd one (``_SameConv2d``); the stem and the
  max-pool pad (3, 3) and (1, 1) explicitly, as in the JAX package;
* flax's norms use ``epsilon=1e-6``; the GroupNorm's group count halves until
  it divides the channel count (timm's rule), and ``norm_layer="layernorm"``
  normalizes each pixel over its channels only (flax ``LayerNorm`` on the
  NHWC last axis);
* ``compute_dtype="bfloat16"`` runs the convolutions in bf16 under autocast,
  with the norms, the pooling and every parameter in float32.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Sequence
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

FLAX_EPS = 1e-6


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class _SameConv2d(nn.Conv2d):
    """Bias-free convolution with flax's ``padding="SAME"``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride, padding=0, bias=False)

    def forward(self, x):
        (top, bottom), (left, right) = (
            _same_pads(n, k, s) for n, k, s in zip(x.shape[-2:], self.kernel_size, self.stride)
        )
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, None, self.stride)


class _GroupNorm(nn.GroupNorm):
    """flax ``GroupNorm`` (eps 1e-6) in float32, whatever the input dtype."""

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)


class ChannelLayerNorm(nn.Module):
    """flax ``LayerNorm`` on NHWC's last axis: each pixel normalized over its
    channels, with a per-channel scale and bias, in float32."""

    def __init__(self, channels: int, eps: float = FLAX_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        x = x.float()
        mean = x.mean(dim=1, keepdim=True)
        var = (x - mean).square().mean(dim=1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


def make_norm(norm_layer: str, channels: int, num_groups: int = 32) -> nn.Module:
    if norm_layer == "groupnorm":
        g = num_groups
        while channels % g:
            g //= 2
        return _GroupNorm(g, channels, eps=FLAX_EPS)
    if norm_layer == "layernorm":
        return ChannelLayerNorm(channels)
    raise ValueError(f"Unsupported norm_layer {norm_layer!r}")


class BasicBlock(nn.Module):
    """Two 3x3 convolutions; a 1x1 projection of the residual where the
    shape changes. ``convs``/``norms`` index as flax's ``Conv_k``/norm ``_k``."""

    expansion = 1

    def __init__(self, cin: int, filters: int, norm: Callable[[int], nn.Module], stride: int = 1):
        super().__init__()
        self.project = stride != 1 or cin != filters
        convs = [_SameConv2d(cin, filters, 3, stride), _SameConv2d(filters, filters, 3)]
        if self.project:
            convs.append(_SameConv2d(cin, filters, 1, stride))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norm(filters) for _ in convs)

    def forward(self, x):
        y = F.relu(self.norms[0](self.convs[0](x)))
        y = self.norms[1](self.convs[1](y))
        residual = self.norms[2](self.convs[2](x)) if self.project else x
        return F.relu(y + residual)


class BottleneckBlock(nn.Module):
    """1x1, 3x3 (strided), 1x1 to 4x the filters; a projected residual where
    the shape changes."""

    expansion = 4

    def __init__(self, cin: int, filters: int, norm: Callable[[int], nn.Module], stride: int = 1):
        super().__init__()
        cout = filters * 4
        self.project = stride != 1 or cin != cout
        convs = [_SameConv2d(cin, filters, 1), _SameConv2d(filters, filters, 3, stride),
                 _SameConv2d(filters, cout, 1)]
        if self.project:
            convs.append(_SameConv2d(cin, cout, 1, stride))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norm(c.out_channels) for c in convs)

    def forward(self, x):
        y = F.relu(self.norms[0](self.convs[0](x)))
        y = F.relu(self.norms[1](self.convs[1](y)))
        y = self.norms[2](self.convs[2](y))
        residual = self.norms[3](self.convs[3](x)) if self.project else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Feature-extracting ResNet: (B, C, H, W) -> (B, F) pooled float32
    features. ``blocks`` is flat, in flax's ``BasicBlock_k`` order."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        block: type = BasicBlock,
        num_filters: int = 64,
        norm_layer: str = "groupnorm",
        num_groups: int = 32,
        compute_dtype: str = "float32",
        in_chans: int = 1,
    ):
        super().__init__()
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"Unsupported compute_dtype {compute_dtype!r}")
        self.norm_layer = norm_layer
        self.compute_dtype = compute_dtype
        norm = partial(make_norm, norm_layer, num_groups=num_groups)
        self.conv1 = nn.Conv2d(in_chans, num_filters, 7, 2, padding=3, bias=False)
        self.norm1 = norm(num_filters)
        blocks, cin = [], num_filters
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                filters = num_filters * 2**i
                blocks.append(block(cin, filters, norm, 2 if i > 0 and j == 0 else 1))
                cin = filters * block.expansion
        self.blocks = nn.ModuleList(blocks)
        self.num_features = cin

    def forward(self, x):
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == "bfloat16"):
            x = F.relu(self.norm1(self.conv1(x)))
            x = F.max_pool2d(x, 3, 2, padding=1)
            for blk in self.blocks:
                x = blk(x)
        return x.float().mean(dim=(2, 3))


_CONFIGS = {
    "resnet18": dict(stage_sizes=[2, 2, 2, 2], block=BasicBlock),
    "resnet34": dict(stage_sizes=[3, 4, 6, 3], block=BasicBlock),
    "resnet50": dict(stage_sizes=[3, 4, 6, 3], block=BottleneckBlock),
    "resnet101": dict(stage_sizes=[3, 4, 23, 3], block=BottleneckBlock),
}


def create_backbone(
    model_name: str, norm_layer: str = "groupnorm", compute_dtype: str = "float32"
) -> ResNet:
    if model_name not in _CONFIGS:
        raise ValueError(
            f"Unknown model_name {model_name!r}; available: {sorted(_CONFIGS)}"
        )
    cfg = _CONFIGS[model_name]
    return ResNet(
        stage_sizes=cfg["stage_sizes"], block=cfg["block"],
        norm_layer=norm_layer, compute_dtype=compute_dtype,
    )


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator | None = None):
    """flax's default kernel init: a normal truncated at two deviations,
    rescaled so that its variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
