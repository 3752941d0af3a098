"""Random 6-DoF pose sampling for training: counterpart of
``xvr_tpu.train.sampler``. Draws are uniform on the ranges, the three angles
are wrapped to (-180, 180], and the rotation is intrinsic ZXY Euler in
degrees. Randomness comes from an explicit ``torch.Generator``; the poses
follow from the draws alone (:func:`pose_from_uniforms`)."""

from __future__ import annotations

import torch

from ..geometry import RigidTransform, convert
from ..utils.profiling import host_sync

# the order of the draws: alpha, beta, gamma, tx, ty, tz
RANGE_KEYS = ("alpha", "beta", "gamma", "tx", "ty", "tz")


def pose_from_uniforms(
    u: torch.Tensor,
    alphamin: float, alphamax: float,
    betamin: float, betamax: float,
    gammamin: float, gammamax: float,
    txmin: float, txmax: float,
    tymin: float, tymax: float,
    tzmin: float, tzmax: float,
) -> RigidTransform:
    """(B, 6) uniforms on [0, 1), columns in :data:`RANGE_KEYS` order -> poses."""
    lo = [alphamin, betamin, gammamin, txmin, tymin, tzmin]
    hi = [alphamax, betamax, gammamax, txmax, tymax, tzmax]
    host_sync(u, 2)  # the bounds' copies from the host
    lo_t = torch.tensor(lo, dtype=u.dtype, device=u.device)
    hi_t = torch.tensor(hi, dtype=u.dtype, device=u.device)
    x = lo_t + u * (hi_t - lo_t)
    rot = torch.remainder(x[:, :3] + 180.0, 360.0) - 180.0
    return convert(rot, x[:, 3:], parameterization="euler_angles", convention="ZXY", degrees=True)


def get_random_pose(
    generator: torch.Generator,
    alphamin: float, alphamax: float,
    betamin: float, betamax: float,
    gammamin: float, gammamax: float,
    txmin: float, txmax: float,
    tymin: float, tymax: float,
    tzmin: float, tzmax: float,
    batch_size: int,
    device=None,
) -> RigidTransform:
    """``batch_size`` poses drawn uniformly on the ranges from ``generator``
    (on its device unless ``device`` is given)."""
    device = generator.device if device is None else device
    u = torch.rand((batch_size, 6), generator=generator, device=generator.device).to(device)
    return pose_from_uniforms(u, alphamin, alphamax, betamin, betamax, gammamin, gammamax,
                              txmin, txmax, tymin, tymax, tzmin, tzmax)
