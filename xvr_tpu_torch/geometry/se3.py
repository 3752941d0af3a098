"""SE(3) rigid transforms, in PyTorch.

Counterpart of ``xvr_tpu.geometry.se3``, with the same conventions:

* A :class:`RigidTransform` wraps a (..., 4, 4) homogeneous matrix acting on
  column vectors: ``x_world = R @ x + t``.
* ``a.compose(b)`` applies ``a``, then ``b``: ``b.matrix @ a.matrix``.
* ``convert(rot, xyz)`` reads ``xyz`` in the camera (body) frame: the matrix
  is ``[R | R @ xyz]``, so ``xyz = (0, ty, 0)`` orbits the world origin at
  radius ``ty`` for any rotation (the C-arm geometry).
  ``RigidTransform.convert`` inverts it and returns ``R^T t``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.autograd.function import once_differentiable

from . import so3
from .so3 import N_ANGULAR_COMPONENTS  # noqa: F401  (re-export)


@dataclass(frozen=True)
class RigidTransform:
    """Batched SE(3) transform backed by a (..., 4, 4) matrix."""

    matrix: torch.Tensor

    @classmethod
    def identity(cls, batch_shape=(), dtype=torch.float32, device="cuda") -> "RigidTransform":
        eye = torch.eye(4, dtype=dtype, device=device)
        return cls(eye.expand(tuple(batch_shape) + (4, 4)).clone())

    @property
    def R(self) -> torch.Tensor:
        return self.matrix[..., :3, :3]

    @property
    def t(self) -> torch.Tensor:
        return self.matrix[..., :3, 3]

    @property
    def device(self) -> torch.device:
        return self.matrix.device

    def compose(self, other: "RigidTransform") -> "RigidTransform":
        """Apply ``self`` first, then ``other``."""
        return RigidTransform(other.matrix @ self.matrix)

    def __matmul__(self, other: "RigidTransform") -> "RigidTransform":
        return RigidTransform(self.matrix @ other.matrix)

    def inverse(self) -> "RigidTransform":
        Rt = self.R.transpose(-1, -2)
        t = -(Rt @ self.t[..., None])[..., 0]
        return RigidTransform(make_matrix(Rt, t))

    def __call__(self, pts: torch.Tensor) -> torch.Tensor:
        """Apply to points (..., N, 3) -> (..., N, 3)."""
        return pts @ self.R.transpose(-1, -2) + self.t[..., None, :]

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        return self(pts)

    def __getitem__(self, idx) -> "RigidTransform":
        return RigidTransform(self.matrix[idx])

    def __len__(self) -> int:
        if self.matrix.ndim < 3:
            raise TypeError("len() of an unbatched RigidTransform")
        return self.matrix.shape[0]

    @property
    def batch_shape(self):
        return tuple(self.matrix.shape[:-2])

    def convert(self, parameterization: str, convention: str | None = None, degrees: bool = False):
        """Matrix -> (rot, xyz) parameters; the inverse of :func:`convert`."""
        R = self.R
        t = (R.transpose(-1, -2) @ self.t[..., None])[..., 0]
        if parameterization == "euler_angles":
            if convention is None:
                raise ValueError("euler_angles requires a convention")
            return so3.matrix_to_euler(R, convention, degrees=degrees), t
        if parameterization == "axis_angle":
            return so3.matrix_to_axis_angle(R), t
        if parameterization == "quaternion":
            return so3.matrix_to_quaternion(R), t
        if parameterization == "rotation_6d":
            return so3.matrix_to_rotation_6d(R), t
        if parameterization == "rotation_10d":
            return so3.matrix_to_rotation_10d(R), t
        if parameterization == "quaternion_adjugate":
            return so3.matrix_to_quaternion_adjugate(R), t
        if parameterization == "matrix":
            return R, t
        if parameterization == "se3_log_map":
            return se3_log_map(self)
        raise ValueError(f"Unknown parameterization {parameterization!r}")


def _shared_adjoint_plain(g: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``rays_adjoint`` kernel, autograd's own product:
    the cotangent ``g`` (..., N, 3) of ``q @ R^T + t`` -> the pose matrix's
    (..., 4, 4), bottom row 0."""
    dR = (q.expand(g.shape).transpose(-1, -2) @ g).transpose(-1, -2)
    top = torch.cat([dR, g.sum(dim=-2)[..., None]], dim=-1)
    return torch.cat([top, torch.zeros_like(top[..., :1, :])], dim=-2)


class _TransformShared(torch.autograd.Function):
    """``q @ R^T + t`` for one point set ``q`` (N, 3) under every pose of a
    batch. The pose's cotangent reduces over the points: on CUDA tensors in
    one kernel (``render/_cuda.py`` ``rays_adjoint``), on CPU tensors by
    :func:`_shared_adjoint_plain`."""

    @staticmethod
    def forward(ctx, matrix, q):
        ctx.save_for_backward(matrix, q)
        return RigidTransform(matrix)(q.expand(matrix.shape[:-2] + q.shape))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        matrix, q = ctx.saved_tensors
        g_matrix = g_q = None
        if ctx.needs_input_grad[0]:
            if g.is_cuda:
                from ..render import _cuda  # here: render imports this package

                n = q.shape[0]
                g_matrix = _cuda.rays_adjoint(g.reshape(-1, n, 3).contiguous(), q.contiguous())
                g_matrix = g_matrix.reshape(matrix.shape)
            else:
                g_matrix = _shared_adjoint_plain(g, q)
        if ctx.needs_input_grad[1]:
            g_q = (g @ matrix[..., :3, :3]).sum_to_size(q.shape)
        return g_matrix, g_q


def transform_shared(matrix: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``RigidTransform(matrix)(q)`` for poses ``matrix`` (..., 4, 4) that all
    map the same points ``q`` (N, 3) -> (..., N, 3), with the same bits. Its
    pose gradient is a reduction over the points, not a batched product."""
    return _TransformShared.apply(matrix, q)


def make_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from rotation (..., 3, 3) and translation (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    from ..utils.device import device_constant  # here: utils imports this module

    bottom = device_constant((0.0, 0.0, 0.0, 1.0), R.dtype, R.device)
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


def convert(
    rot,
    xyz=None,
    parameterization: str = "euler_angles",
    convention: str | None = None,
    degrees: bool = False,
) -> RigidTransform:
    """(rot, xyz) parameters -> :class:`RigidTransform`."""
    rot = torch.as_tensor(rot)
    if xyz is not None:
        xyz = torch.as_tensor(xyz, device=rot.device)
    if parameterization == "se3_log_map":
        if xyz is None:
            raise ValueError("se3_log_map requires both rot (omega) and xyz (upsilon)")
        return se3_exp_map(rot, xyz)
    if parameterization == "euler_angles":
        if convention is None:
            raise ValueError("euler_angles requires a convention")
        R = so3.euler_to_matrix(rot, convention, degrees=degrees)
    elif parameterization == "axis_angle":
        R = so3.axis_angle_to_matrix(rot)
    elif parameterization == "quaternion":
        R = so3.quaternion_to_matrix(rot)
    elif parameterization == "rotation_6d":
        R = so3.rotation_6d_to_matrix(rot)
    elif parameterization == "rotation_10d":
        R = so3.rotation_10d_to_matrix(rot)
    elif parameterization == "quaternion_adjugate":
        R = so3.quaternion_adjugate_to_matrix(rot)
    elif parameterization == "matrix":
        R = rot
    else:
        raise ValueError(f"Unknown parameterization {parameterization!r}")
    if xyz is None:
        xyz = torch.zeros(rot.shape[:-1] + (3,), dtype=rot.dtype, device=rot.device)
    t = (R @ xyz[..., None])[..., 0]
    return RigidTransform(make_matrix(R, t))


def make_translation(xyz: torch.Tensor) -> RigidTransform:
    """Pure translation."""
    xyz = torch.as_tensor(xyz)
    R = torch.eye(3, dtype=xyz.dtype, device=xyz.device).expand(xyz.shape[:-1] + (3, 3))
    return RigidTransform(make_matrix(R, xyz))


# ---------------------------------------------------------------------------
# se(3) exp/log maps
# ---------------------------------------------------------------------------


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """V such that exp([w, v]) has translation V @ v."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2_safe * theta)
    )
    W = so3.hat(w)
    return so3._eye_like(W) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def _so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    half = 0.5 * torch.sqrt(theta2_safe)
    cot = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half)) / theta2_safe,
    )
    W = so3.hat(w)
    return so3._eye_like(W) - 0.5 * W + cot[..., None, None] * (W @ W)


def se3_exp_map(omega: torch.Tensor, upsilon: torch.Tensor) -> RigidTransform:
    R = so3.axis_angle_to_matrix(omega)
    t = (_so3_left_jacobian(omega) @ upsilon[..., None])[..., 0]
    return RigidTransform(make_matrix(R, t))


def se3_log_map(T: RigidTransform):
    omega = so3.matrix_to_axis_angle(T.R)
    upsilon = (_so3_left_jacobian_inv(omega) @ T.t[..., None])[..., 0]
    return omega, upsilon


def project_onto_SO3(T: RigidTransform) -> RigidTransform:
    """Project the linear part of an affine 4x4 onto SO(3), keeping the image
    of the origin: ``t' = R @ (A^-1 @ t)``."""
    A, t = T.matrix[..., :3, :3], T.matrix[..., :3, 3]
    R = so3.project_onto_so3(A)
    t_local = torch.linalg.solve(A, t[..., None])
    return RigidTransform(make_matrix(R, (R @ t_local)[..., 0]))
