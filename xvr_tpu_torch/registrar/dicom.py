"""Initial pose from the X-ray's own DICOM positioner metadata: counterpart
of ``xvr_tpu.registrar.dicom``. The C-arm's primary and secondary positioner
angles and the source-to-patient distance give a coarse starting pose, with
no trained model."""

from __future__ import annotations

from ..io.xray import parse_dicom_pose, read_xray
from .base import RegistrarBase, clinical_defaults


class RegistrarDicom(RegistrarBase):
    def __init__(self, volume, mask, orientation, **kwargs):
        super().__init__(
            volume, mask, orientation,
            save_kwargs={"type": "dicom"},
            **clinical_defaults(kwargs),
        )

    def initialize_pose(self, i2d):
        xray = read_xray(i2d, self.crop, self.subtract_background, self.linearize, self.reducefn)
        return (*xray, parse_dicom_pose(i2d, self.orientation, device=self.device))
