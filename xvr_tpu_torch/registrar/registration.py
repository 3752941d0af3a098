"""Registration: a pose parameterized for gradient optimization.

Counterpart of ``xvr_tpu.registrar.registration``, the compatibility class
for code written against ``diffdrr.registration.Registration``. The
registration engine does not route through it: its stage loop keeps
(rotation, translation) as plain tensors in the optimizer state.
"""

from __future__ import annotations

import torch

from ..geometry import RigidTransform, convert
from ..render.projector import Projector


class Registration:
    def __init__(
        self,
        projector: Projector,
        rotation: torch.Tensor,
        translation: torch.Tensor,
        parameterization: str = "euler_angles",
        convention: str | None = "ZXY",
    ):
        self.projector = projector
        self.rotation = torch.as_tensor(rotation, device=projector.device)
        self.translation = torch.as_tensor(translation, device=projector.device)
        self.parameterization = parameterization
        self.convention = convention

    @property
    def pose(self) -> RigidTransform:
        return convert(
            self.rotation,
            self.translation,
            parameterization=self.parameterization,
            convention=self.convention,
        )

    def __call__(self, density=None) -> torch.Tensor:
        return self.projector(self.pose, density=density)
