"""Geodesic distances on SO(3)/SE(3): counterpart of
``xvr_tpu.metrics.geodesic``. The rotation geodesic becomes millimetres
through the focal length ``sdd``; the translation term is Euclidean; the
double geodesic combines the two in quadrature."""

from __future__ import annotations

import math

import torch

from ..geometry.se3 import RigidTransform


def so3_angle(R1: torch.Tensor, R2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Rotation angle (radians) from ``||R1 - R2||_F = 2 sqrt(2) |sin(theta/2)|``."""
    ss = torch.sum((R1 - R2) ** 2, dim=(-2, -1))
    small = ss < 1e-24
    d = torch.sqrt(torch.where(small, torch.ones_like(ss), ss))
    arg = torch.clamp(d / (2.0 * math.sqrt(2.0)), 0.0, 1.0 - eps)
    return torch.where(small, torch.zeros_like(ss), 2.0 * torch.asin(arg))


def double_geodesic(pose1: RigidTransform, pose2: RigidTransform, sdd: float, eps: float = 1e-6):
    """-> (rot_geo_mm, trans_geo_mm, double_geo_mm), each (...,)."""
    rgeo = sdd * so3_angle(pose1.R, pose2.R, eps)
    tgeo = torch.linalg.norm(pose1.t - pose2.t, dim=-1)
    return rgeo, tgeo, torch.sqrt(rgeo**2 + tgeo**2)
