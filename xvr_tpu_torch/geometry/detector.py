"""C-arm detector geometry: intrinsics -> per-pixel rays, projections.

Counterpart of ``xvr_tpu.geometry.detector`` with the same camera frame: the
source sits at the camera origin, the detector plane is centred at
``(0, -sdd, 0)`` (the beam travels along -y), image rows run along -z and
image columns along +x (negated with ``reverse_x_axis``). A pose maps camera
coordinates to world (volume, mm) coordinates.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as _replace

import numpy as np
import torch

from .se3 import RigidTransform, transform_shared


@dataclass(frozen=True)
class Detector:
    sdd: float
    height: int
    width: int
    delx: float
    dely: float
    x0: float = 0.0
    y0: float = 0.0
    reverse_x_axis: bool = False

    def replace(self, **kwargs) -> "Detector":
        return _replace(self, **kwargs)

    def rescale(self, factor: float) -> "Detector":
        """Coarsen the detector by ``factor`` (> 1 = fewer, larger pixels)."""
        height = max(int(round(self.height / factor)), 1)
        width = max(int(round(self.width / factor)), 1)
        return self.replace(
            height=height,
            width=width,
            delx=self.delx * self.height / height,
            dely=self.dely * self.width / width,
        )

    @property
    def n_rays(self) -> int:
        return self.height * self.width

    def _target_grid(self, dtype=torch.float32, device="cuda") -> torch.Tensor:
        """Detector pixel centres in the camera frame, (H*W, 3) row-major."""
        i = torch.arange(self.height, dtype=dtype, device=device)
        j = torch.arange(self.width, dtype=dtype, device=device)
        v = (i - (self.height - 1) / 2.0) * self.delx + self.y0  # rows, -z
        u = (j - (self.width - 1) / 2.0) * self.dely + self.x0  # cols, +x
        sx = -1.0 if self.reverse_x_axis else 1.0
        x = (sx * u)[None, :].expand(self.height, self.width)
        z = (-v)[:, None].expand(self.height, self.width)
        y = torch.full((self.height, self.width), -self.sdd, dtype=dtype, device=device)
        return torch.stack([x, y, z], dim=-1).reshape(-1, 3)

    def rays_numpy(self, pose_matrix):
        """Host-side (NumPy, float64) twin of :meth:`rays` for steepness
        measurements. ``pose_matrix``: (B, 4, 4) already-oriented poses.
        Returns float32 (source (B, 1, 3), target (B, H*W, 3))."""
        M = np.asarray(pose_matrix, dtype=np.float64).reshape(-1, 4, 4)
        i = np.arange(self.height, dtype=np.float64)
        j = np.arange(self.width, dtype=np.float64)
        v = (i - (self.height - 1) / 2.0) * self.delx + self.y0
        u = (j - (self.width - 1) / 2.0) * self.dely + self.x0
        sx = -1.0 if self.reverse_x_axis else 1.0
        x = np.broadcast_to(sx * u[None, :], (self.height, self.width))
        z = np.broadcast_to(-v[:, None], (self.height, self.width))
        y = np.full((self.height, self.width), -self.sdd)
        tgt_cam = np.stack([x, y, z], axis=-1).reshape(-1, 3)
        R, t = M[:, :3, :3], M[:, :3, 3]
        source = t[:, None, :]
        target = np.einsum("bij,nj->bni", R, tgt_cam) + t[:, None, :]
        return source.astype(np.float32), target.astype(np.float32)

    def rays(self, pose: RigidTransform, calibration: RigidTransform | None = None):
        """World-frame ray endpoints for a batch of poses: source (..., 1, 3)
        and target (..., H*W, 3), on the pose's device."""
        m = pose.matrix
        target_cam = self._target_grid(m.dtype, m.device)
        if calibration is None:
            # the camera origin: its pose gradient needs no product
            source = pose.t[..., None, :]
        else:
            source = pose(calibration.t.expand(pose.batch_shape + (1, 3)))
            target_cam = calibration(target_cam[None])[0]
        return source, transform_shared(m, target_cam)

    def perspective_projection(self, pose: RigidTransform, pts: torch.Tensor) -> torch.Tensor:
        """Project world points (..., N, 3) onto the detector -> pixel (col, row)."""
        cam = pose.inverse()(pts)
        lam = -self.sdd / cam[..., 1]
        proj = cam * lam[..., None]
        sx = -1.0 if self.reverse_x_axis else 1.0
        col = (proj[..., 0] * sx - self.x0) / self.dely + (self.width - 1) / 2.0
        row = (-proj[..., 2] - self.y0) / self.delx + (self.height - 1) / 2.0
        return torch.stack([col, row], dim=-1)

    def inverse_projection(self, pose: RigidTransform, pts2d: torch.Tensor) -> torch.Tensor:
        """Pixel (col, row) (..., N, 2) -> world position on the detector plane."""
        col, row = pts2d[..., 0], pts2d[..., 1]
        u = (col - (self.width - 1) / 2.0) * self.dely + self.x0
        v = (row - (self.height - 1) / 2.0) * self.delx + self.y0
        sx = -1.0 if self.reverse_x_axis else 1.0
        cam = torch.stack([sx * u, torch.full_like(u, -self.sdd), -v], dim=-1)
        return pose(cam)
