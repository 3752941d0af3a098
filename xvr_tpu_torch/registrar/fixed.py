"""Initial pose supplied directly by the user: counterpart of
``xvr_tpu.registrar.fixed``. The rotation components are read in the
registrar's own parameterization and convention."""

from __future__ import annotations

import torch

from ..geometry import convert
from ..io.xray import read_xray
from .base import RegistrarBase, clinical_defaults


class RegistrarFixed(RegistrarBase):
    def __init__(self, volume, mask, orientation, rot, xyz, **kwargs):
        super().__init__(
            volume, mask, orientation,
            save_kwargs={"type": "fixed"},
            **clinical_defaults(kwargs),
        )
        self.init_pose = convert(
            torch.tensor([rot], dtype=torch.float32, device=self.device),
            torch.tensor([xyz], dtype=torch.float32, device=self.device),
            parameterization=self.parameterization,
            convention=self.convention,
        )

    def initialize_pose(self, i2d):
        xray = read_xray(i2d, self.crop, self.subtract_background, self.linearize, self.reducefn)
        return (*xray, self.init_pose)
