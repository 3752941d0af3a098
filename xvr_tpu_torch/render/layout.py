"""Host-side volume-layout helpers of the shear-warp and slab renderers.

NumPy copies of the three helpers of ``xvr_tpu.render.pallas`` that the
renderer selection calls: the march/window/lane permutation of the volume
axes and the ray-steepness measurement that decides whether a kernel may
render a pose at all. They live here, apart from
:mod:`~xvr_tpu_torch.render.pallas` (which re-exports them), because the
shear-warp module needs them and the slab module needs the shear-warp one.
"""

from __future__ import annotations

import numpy as np


def _choose_permutation(d_mean: np.ndarray, u_dir: np.ndarray | None = None) -> tuple[int, int, int]:
    """March axis = dominant mean ray direction; of the two transverse axes,
    the one most aligned with the detector column direction ``u_dir`` is the
    lane axis (the other is the window axis)."""
    march = int(np.argmax(np.abs(d_mean)))
    rest = [a for a in range(3) if a != march]
    if u_dir is not None:
        lane = rest[int(np.argmax([abs(u_dir[a]) for a in rest]))]
    else:
        lane = rest[1]
    win = rest[0] if lane == rest[1] else rest[1]
    return march, win, lane


def choose_permutation_for_pose(pose_R: np.ndarray, affine_inverse: np.ndarray) -> tuple[int, int, int]:
    """Static permutation from a representative pose: the beam direction
    -y_cam picks the march axis, the column direction +x_cam the lane axis."""
    A = np.asarray(affine_inverse)[:3, :3]
    R = np.asarray(pose_R)
    beam_vox = A @ (R @ np.asarray([0.0, -1.0, 0.0]))
    u_vox = A @ (R @ np.asarray([1.0, 0.0, 0.0]))
    return _choose_permutation(beam_vox, u_vox)


def measured_steepness(source, target, affine_inverse, perm: tuple[int, int, int]) -> float:
    """max over rays of max(|d_win|, |d_lane|) / |d_march|."""
    A = np.asarray(affine_inverse)
    s = np.asarray(source) @ A[:3, :3].T + A[:3, 3]
    t = np.asarray(target) @ A[:3, :3].T + A[:3, 3]
    d = t - np.broadcast_to(s, t.shape)
    march, win, lane = perm
    d0 = np.maximum(np.abs(d[..., march]), 1e-9)
    trans = np.maximum(np.abs(d[..., win]), np.abs(d[..., lane]))
    return float((trans / d0).max())
