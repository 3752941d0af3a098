"""CT/MR volume representation and HU -> attenuation transfer.

Counterpart of ``xvr_tpu.render.volume``. A :class:`Volume` holds the raw
intensity grid (indexed ``data[i, j, k]``), an affine mapping voxel indices to
world millimetres and an optional integer labelmap, all on one device. Voxel
centres sit at integer indices; the volume spans ``[-0.5, n - 0.5]`` along
each axis in index space.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..geometry.se3 import RigidTransform, make_matrix


@dataclass(frozen=True)
class Volume:
    """Intensity volume + voxel->world affine (+ optional labelmap)."""

    data: torch.Tensor  # (nx, ny, nz) raw intensities (HU for CT)
    affine: torch.Tensor  # (4, 4) voxel index -> world mm
    mask: torch.Tensor | None = None  # (nx, ny, nz) integer labels
    orientation: str | None = "AP"

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def affine_inverse(self) -> torch.Tensor:
        # inv_ex: no host synchronisation for the error check on every render
        return torch.linalg.inv_ex(self.affine)[0]

    @property
    def spacing(self) -> torch.Tensor:
        return torch.linalg.norm(self.affine[:3, :3], dim=0)

    @property
    def center(self) -> torch.Tensor:
        """World coordinates of the central voxel index ``(n - 1) / 2``."""
        idx = (torch.tensor(self.data.shape, dtype=self.affine.dtype, device=self.device) - 1.0) / 2.0
        return self.affine[:3, :3] @ idx + self.affine[:3, 3]

    def center_translation(self) -> RigidTransform:
        eye = torch.eye(3, dtype=self.affine.dtype, device=self.device)
        return RigidTransform(make_matrix(eye, self.center))

    def world_to_voxel(self, pts: torch.Tensor) -> torch.Tensor:
        Ainv = self.affine_inverse
        return pts @ Ainv[:3, :3].T + Ainv[:3, 3]


def transform_hu_to_density(volume: torch.Tensor, bone_attenuation_multiplier: float = 1.0) -> torch.Tensor:
    """Piecewise HU -> relative attenuation, min-max rescaled to [0, 1]:
    air (<= -800 HU) maps to the soft-tissue floor, soft tissue passes
    through, bone (> 350 HU) is scaled by the multiplier."""
    v = volume.to(torch.float32)
    air = v <= -800.0
    bone = v > 350.0
    big = torch.finfo(torch.float32).max
    soft_min = torch.where(air, torch.full_like(v, big), v).min()
    if not (torch.isfinite(soft_min) and soft_min < big):
        soft_min = torch.tensor(-800.0, device=v.device)
    density = torch.where(air, soft_min, v)
    density = torch.where(bone, v * bone_attenuation_multiplier, density)
    density = density - density.min()
    return density / torch.clamp(density.max(), min=1e-12)


def _centered(data: np.ndarray, spacing: float, device, orientation) -> Volume:
    """A Volume of ``data`` with isotropic ``spacing``, centred at the origin."""
    c = (data.shape[0] - 1) / 2.0
    affine = np.eye(4, dtype=np.float32) * spacing
    affine[3, 3] = 1.0
    affine[:3, 3] = -c * spacing
    return Volume(data=torch.as_tensor(data, device=device),
                  affine=torch.as_tensor(affine, device=device), orientation=orientation)


def load_example_ct(orientation: str | None = "AP", n: int = 96, spacing: float = 2.0,
                    device="cuda") -> Volume:
    """A synthetic example CT: air around a soft-tissue ellipsoid with a bone
    shell and an asymmetric bone marker (no download)."""
    c = (n - 1) / 2.0
    idx = np.arange(n)
    X, Y, Z = np.meshgrid(idx, idx, idx, indexing="ij")
    rx, ry, rz = n / 2.6, n / 3.2, n / 2.4
    r2 = ((X - c) / rx) ** 2 + ((Y - c) / ry) ** 2 + ((Z - c) / rz) ** 2
    hu = np.where(r2 <= 1.0, 40.0, -1000.0).astype(np.float32)
    shell = (r2 <= 0.55) & (r2 >= 0.35)
    hu += np.where(shell, 900.0, 0.0)
    hu[int(c) + n // 6 : int(c) + n // 4, int(c) - 2 : int(c) + 2, int(c) - 2 : int(c) + 2] = 1400.0
    return _centered(hu, spacing, device, orientation)


def make_test_volume(n: int = 32, spacing: float = 1.0, kind: str = "cube", device="cuda") -> Volume:
    """Synthetic phantoms for tests and benchmarks: ``kind`` is "cube",
    "sphere", "gradient" or "random" (seeded)."""
    c = (n - 1) / 2.0
    idx = np.arange(n)
    X, Y, Z = np.meshgrid(idx, idx, idx, indexing="ij")
    if kind == "cube":
        half = n // 4
        data = (np.abs(X - c) <= half) & (np.abs(Y - c) <= half) & (np.abs(Z - c) <= half)
    elif kind == "sphere":
        data = (X - c) ** 2 + (Y - c) ** 2 + (Z - c) ** 2 <= (n / 4) ** 2
    elif kind == "gradient":
        data = (X + 2 * Y + 3 * Z).astype(np.float32) / (6.0 * n)
    elif kind == "random":
        data = np.random.default_rng(0).uniform(size=(n, n, n))
    else:
        raise ValueError(kind)
    return _centered(np.asarray(data, np.float32), spacing, device, orientation="AP")
