"""PoseRegressor: a ResNet backbone and two linear pose heads.

Counterpart of ``xvr_tpu.models.regressor``: the heads emit
``N_ANGULAR_COMPONENTS[parameterization]`` rotation parameters and a
translation scaled by ``unit_conversion_factor`` (1000: the network regresses
metres, poses are millimetres), decoded to a :class:`RigidTransform` by
:func:`~xvr_tpu_torch.geometry.convert`. Checkpoints are the JAX package's
(:mod:`xvr_tpu_torch.train.checkpoint`), weights carried across by
:func:`~xvr_tpu_torch.state.from_flax_params`.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from ..geometry import N_ANGULAR_COMPONENTS, RigidTransform, convert
from .resnet import ChannelLayerNorm, create_backbone, lecun_normal_


class PoseRegressor(nn.Module):
    """(B, 1, H, W) NCHW -> (rot, xyz). ``rot_head`` and ``xyz_head`` are
    flax's ``Dense_0`` and ``Dense_1``."""

    def __init__(
        self,
        model_name: str = "resnet18",
        parameterization: str = "quaternion_adjugate",
        convention: str | None = "ZXY",
        norm_layer: str = "groupnorm",
        unit_conversion_factor: float = 1000.0,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        self.model_name = model_name
        self.parameterization = parameterization
        self.convention = convention
        self.unit_conversion_factor = unit_conversion_factor
        self.backbone = create_backbone(model_name, norm_layer, compute_dtype)
        n = self.backbone.num_features
        self.rot_head = nn.Linear(n, N_ANGULAR_COMPONENTS[parameterization])
        self.xyz_head = nn.Linear(n, 3)
        init_pose_regressor(self)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        feats = self.backbone(x)
        return self.rot_head(feats), self.unit_conversion_factor * self.xyz_head(feats)

    def decode(self, rot: torch.Tensor, xyz: torch.Tensor) -> RigidTransform:
        return convert(rot, xyz, parameterization=self.parameterization,
                       convention=self.convention)

    def predict_pose(self, params, x: torch.Tensor) -> RigidTransform:
        """``params``: a state dict (as :func:`load_model` returns), applied
        like flax's ``model.apply(params, x)``."""
        rot, xyz = functional_call(self, params, (x,))
        return self.decode(rot, xyz)


def init_pose_regressor(model: PoseRegressor, generator: torch.Generator | None = None):
    """flax's default initialization, drawn from ``generator``: LeCun-normal
    kernels, zero biases, unit norm scales. -> ``model``."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.GroupNorm, ChannelLayerNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    return model


def load_model(ckptpath, meta: bool = False, device="cuda"):
    """Rebuild a PoseRegressor from a self-describing checkpoint of either
    package. -> (model, params, config[, date]); ``params`` is the model's
    state dict, the counterpart of the JAX package's parameter tree. As in
    the JAX package, a config without ``unit_conversion_factor`` reads 1.0."""
    from ..state import from_flax_params
    from ..train.checkpoint import latest_checkpoint, load_checkpoint

    path = latest_checkpoint(ckptpath) or ckptpath
    ckpt = load_checkpoint(path)
    config = ckpt["config"]
    model = PoseRegressor(
        model_name=config["model_name"],
        parameterization=config["parameterization"],
        convention=config.get("convention"),
        norm_layer=config.get("norm_layer", "groupnorm"),
        unit_conversion_factor=float(config.get("unit_conversion_factor", 1.0)),
    )
    model.load_state_dict(from_flax_params(ckpt["model_state_dict"]))
    model = model.to(device).eval()
    params = dict(model.state_dict())
    if meta:
        return model, params, config, ckpt.get("date")
    return model, params, config
