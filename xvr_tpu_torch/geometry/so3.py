"""SO(3) rotation parameterizations and conversions, in PyTorch.

Counterpart of ``xvr_tpu.geometry.so3``: Euler angles with any intrinsic
convention, axis-angle (the so(3) log map), real-first unit quaternions, the
continuous 6D representation, the 10D symmetric-matrix representation and the
quaternion adjugate. Every function broadcasts over leading batch dimensions,
keeps the input's device and dtype, and is differentiable (branches are
``torch.where`` selects with safe operands on the untaken side).
"""

from __future__ import annotations

import torch

N_ANGULAR_COMPONENTS = {
    "axis_angle": 3,
    "euler_angles": 3,
    "se3_log_map": 3,
    "quaternion": 4,
    "rotation_6d": 6,
    "rotation_10d": 10,
    "quaternion_adjugate": 10,
    "matrix": 9,
}


# ---------------------------------------------------------------------------
# Elementary rotations / Euler angles
# ---------------------------------------------------------------------------


def _axis_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) about a named axis for angles in radians."""
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        rows = ((o, z, z), (z, c, -s), (z, s, c))
    elif axis == "Y":
        rows = ((c, z, s), (z, o, z), (-s, z, c))
    elif axis == "Z":
        rows = ((c, -s, z), (s, c, z), (z, z, o))
    else:
        raise ValueError(f"Unknown axis {axis!r}")
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def euler_to_matrix(angles: torch.Tensor, convention: str, degrees: bool = False) -> torch.Tensor:
    """Euler angles (..., 3) -> rotation matrices (..., 3, 3), composed
    intrinsically in the order given: ``R = R_c0(a0) @ R_c1(a1) @ R_c2(a2)``."""
    if len(convention) != 3 or any(a not in "XYZ" for a in convention):
        raise ValueError(f"Invalid Euler convention {convention!r}")
    if degrees:
        angles = torch.deg2rad(angles)
    R = _axis_rotation(convention[0], angles[..., 0])
    R = R @ _axis_rotation(convention[1], angles[..., 1])
    return R @ _axis_rotation(convention[2], angles[..., 2])


def _index(axis: str) -> int:
    return "XYZ".index(axis)


def _angle_from_tan(axis, other_axis, data, horizontal: bool, tait_bryan: bool):
    """Recover one outer Euler angle from a row/column of the rotation matrix."""
    i1, i2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
    if horizontal:
        i2, i1 = i1, i2
    even = (axis + other_axis) in ("XY", "YZ", "ZX")
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def matrix_to_euler(R: torch.Tensor, convention: str, degrees: bool = False) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> intrinsic Euler angles (..., 3)."""
    if len(convention) != 3 or any(a not in "XYZ" for a in convention):
        raise ValueError(f"Invalid Euler convention {convention!r}")
    i0, i2 = _index(convention[0]), _index(convention[2])
    tait_bryan = i0 != i2
    if tait_bryan:
        sign = -1.0 if i0 - i2 in (-1, 2) else 1.0
        central = torch.asin(torch.clamp(R[..., i0, i2] * sign, -1.0, 1.0))
    else:
        central = torch.acos(torch.clamp(R[..., i0, i0], -1.0, 1.0))
    a0 = _angle_from_tan(convention[0], convention[1], R[..., i2], False, tait_bryan)
    a2 = _angle_from_tan(convention[2], convention[1], R[..., i0, :], True, tait_bryan)
    angles = torch.stack([a0, central, a2], dim=-1)
    if degrees:
        angles = torch.rad2deg(angles)
    return angles


# ---------------------------------------------------------------------------
# Quaternions (real-first: w, x, y, z)
# ---------------------------------------------------------------------------


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (..., 4) (w, x, y, z) -> rotation matrices (..., 3, 3)."""
    q = _normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = (
        (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    )
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> unit quaternions (..., 4), w >= 0.

    Shepperd's method, branch-free: all four pivot candidates are built and
    the largest pivot is selected."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    pw = torch.clamp(1 + tr, min=1e-12)
    px = torch.clamp(1 + m00 - m11 - m22, min=1e-12)
    py = torch.clamp(1 - m00 + m11 - m22, min=1e-12)
    pz = torch.clamp(1 - m00 - m11 + m22, min=1e-12)

    def cand(parts, p):
        return torch.stack(parts, dim=-1) / (2.0 * torch.sqrt(p)[..., None])

    q_w = cand([pw, m21 - m12, m02 - m20, m10 - m01], pw)
    q_x = cand([m21 - m12, px, m01 + m10, m02 + m20], px)
    q_y = cand([m02 - m20, m01 + m10, py, m12 + m21], py)
    q_z = cand([m10 - m01, m02 + m20, m12 + m21, pz], pz)

    pivots = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    candidates = torch.stack([q_w, q_x, q_y, q_z], dim=-2)  # (..., 4, 4)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(candidates, -2, idx)[..., 0, :]
    q = _normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


# ---------------------------------------------------------------------------
# Axis-angle (so(3) exp/log)
# ---------------------------------------------------------------------------


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> skew-symmetric (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    rows = ((z, -wz, wy), (wz, z, -wx), (-wy, wx, z))
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def axis_angle_to_matrix(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula with a Taylor-safe small-angle branch."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vnorm2 = torch.sum(v * v, dim=-1)
    small = vnorm2 < 1e-18
    vnorm = torch.sqrt(torch.where(small, torch.ones_like(vnorm2), vnorm2))
    theta = 2.0 * torch.atan2(vnorm, w)
    scale = torch.where(small, torch.full_like(theta, 2.0), theta / vnorm)
    return v * scale[..., None]


def matrix_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    """SO(3) log map (..., 3, 3) -> (..., 3). Safe near theta = 0 and pi."""
    return quaternion_to_axis_angle(matrix_to_quaternion(R))


def axis_angle_to_quaternion(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> real-first unit quaternion (..., 4), with a series branch
    near theta = 0."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = theta2 < 1e-12
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    half = 0.5 * torch.where(small, torch.zeros_like(theta), theta)
    sinc = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    return torch.cat([torch.cos(half), sinc * w], dim=-1)


# ---------------------------------------------------------------------------
# 6D continuous representation (Zhou et al., CVPR 2019)
# ---------------------------------------------------------------------------


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = _normalize(a1)
    b2 = _normalize(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(R: torch.Tensor) -> torch.Tensor:
    return torch.cat([R[..., 0, :], R[..., 1, :]], dim=-1)


# ---------------------------------------------------------------------------
# 10D symmetric-matrix representations
# ---------------------------------------------------------------------------
# rotation_10d (Peretroukhin et al., RSS 2020): the rotation is the
# eigenvector of a symmetric 4x4 for its SMALLEST eigenvalue, as a quaternion.
# quaternion_adjugate (Hanson & Hanson, 2022): the 10 unique entries of q q^T.

_TRIU = tuple(tuple(r) for r in torch.triu_indices(4, 4).tolist())


def _triu(device):
    """The upper triangle's indices on ``device``."""
    from ..utils.device import device_constant  # here: utils imports this package

    return tuple(device_constant(r, torch.int64, device) for r in _TRIU)


def vec10_to_symmetric(v: torch.Tensor) -> torch.Tensor:
    """10-vector (..., 10) -> symmetric matrix (..., 4, 4)."""
    A = torch.zeros(v.shape[:-1] + (4, 4), dtype=v.dtype, device=v.device)
    A[(..., *_triu(v.device))] = v
    eye = torch.eye(4, dtype=v.dtype, device=v.device)
    return A + A.transpose(-1, -2) - A * eye


def symmetric_to_vec10(A: torch.Tensor) -> torch.Tensor:
    return A[(..., *_triu(A.device))]


def rotation_10d_to_matrix(v: torch.Tensor) -> torch.Tensor:
    _, eigvecs = torch.linalg.eigh(vec10_to_symmetric(v))
    return quaternion_to_matrix(eigvecs[..., :, 0])


def matrix_to_rotation_10d(R: torch.Tensor) -> torch.Tensor:
    """Canonical (non-unique) 10D embedding: A = I - q q^T."""
    q = matrix_to_quaternion(R)
    A = torch.eye(4, dtype=R.dtype, device=R.device) - q[..., :, None] * q[..., None, :]
    return symmetric_to_vec10(A)


def quaternion_adjugate_to_quaternion(v: torch.Tensor) -> torch.Tensor:
    """10-vector of vech(q q^T) -> q, via the row with the largest diagonal."""
    A = vec10_to_symmetric(v)
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    best = torch.argmax(torch.abs(diag), dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    row = torch.gather(A, -2, idx)[..., 0, :]
    return _normalize(row)


def quaternion_adjugate_to_matrix(v: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(quaternion_adjugate_to_quaternion(v))


def matrix_to_quaternion_adjugate(R: torch.Tensor) -> torch.Tensor:
    q = matrix_to_quaternion(R)
    return symmetric_to_vec10(q[..., :, None] * q[..., None, :])


# ---------------------------------------------------------------------------
# Projection onto SO(3)
# ---------------------------------------------------------------------------


def project_onto_so3(A: torch.Tensor) -> torch.Tensor:
    """Nearest rotation matrix (Frobenius) via SVD, with det forced to +1."""
    U, _, Vh = torch.linalg.svd(A)
    det = torch.linalg.det(U @ Vh)
    S = torch.ones(A.shape[:-2] + (3,), dtype=A.dtype, device=A.device)
    S[..., -1] = det
    return (U * S[..., None, :]) @ Vh
