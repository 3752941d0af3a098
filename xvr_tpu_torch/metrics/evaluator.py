"""Registration error metrics, all in mm: counterpart of
``xvr_tpu.metrics.evaluator``. Mean projection error (mPE, detector-plane
distance of projected fiducials), mean reprojection error (mRPE, 3D distance
between their detector-plane backprojections), mean target registration
error (mTRE, 3D fiducial distance) and the double geodesic."""

from __future__ import annotations

import torch

from ..geometry.se3 import RigidTransform
from ..render.projector import Projector
from .geodesic import double_geodesic


class Evaluator:
    """Callable computing (mpe, mrpe, mtre, dgeo) for pose pairs.

    ``fiducials``: (1, N, 3) ground-truth landmark positions in world mm.
    """

    def __init__(self, projector: Projector, fiducials: torch.Tensor):
        self.projector = projector
        self.fiducials = torch.as_tensor(fiducials, dtype=torch.float32, device=projector.device)

    def __call__(self, true_pose: RigidTransform, pred_pose: RigidTransform) -> torch.Tensor:
        det = self.projector.detector
        x = self.projector.perspective_projection(pred_pose, self.fiducials)
        y = self.projector.perspective_projection(true_pose, self.fiducials)
        mpe = torch.linalg.norm(det.delx * (x - y), dim=-1).mean(dim=-1)

        x3 = self.projector.inverse_projection(pred_pose, x)
        y3 = self.projector.inverse_projection(true_pose, y)
        mrpe = torch.linalg.norm(x3 - y3, dim=-1).mean(dim=-1)

        xw = pred_pose(self.fiducials)
        yw = true_pose(self.fiducials)
        mtre = torch.linalg.norm(xw - yw, dim=-1).mean(dim=-1)

        *_, dgeo = double_geodesic(true_pose, pred_pose, det.sdd, eps=1e-7)
        return torch.stack([mpe.squeeze(), mrpe.squeeze(), mtre.squeeze(), dgeo.squeeze()], dim=-1)
