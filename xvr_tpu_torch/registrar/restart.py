"""Initial pose from an earlier run's result bundle: counterpart of
``xvr_tpu.registrar.restart``. Seeding a run from a saved final pose chains
refinements (finer pyramid scales, or a run that plateaued early)."""

from __future__ import annotations

from ..geometry import RigidTransform
from ..io.xray import read_xray
from .base import RegistrarBase, clinical_defaults


class RegistrarRestart(RegistrarBase):
    def __init__(self, volume, mask, orientation, init_pose: RigidTransform, **kwargs):
        super().__init__(
            volume, mask, orientation,
            save_kwargs={"type": "restart"},
            **clinical_defaults(kwargs),
        )
        self.init_pose = init_pose

    def initialize_pose(self, i2d):
        xray = read_xray(i2d, self.crop, self.subtract_background, self.linearize, self.reducefn)
        return (*xray, self.init_pose)
