"""ITK/ANTs rigid-transform files, dependency-free.

Counterpart of ``xvr_tpu.utils.itk``: parses the ITK "Insight Transform File
V1.0" text format (and the binary .mat that ``ants.write_transform`` writes),
composes the transform with the volume's direction matrix and centre into a
:class:`RigidTransform`, and projects it onto SO(3). The arithmetic is NumPy
on the host. ``ants_rigid_register`` needs the optional antspyx package.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..geometry.se3 import RigidTransform, project_onto_SO3
from ..io.nifti import load_nifti, to_canonical


def read_itk_transform(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """-> (parameters[12], fixed_parameters[3]) from .txt/.tfm/.mat files."""
    path = Path(path)
    raw = path.read_bytes()
    if raw[:1] == b"#" or raw[:9] == b"Insight T":
        params, fixed = None, None
        for line in raw.decode("utf-8", "ignore").splitlines():
            line = line.strip()
            if line.startswith("Parameters:"):
                params = np.array([float(x) for x in line.split(":", 1)[1].split()])
            elif line.startswith("FixedParameters:"):
                fixed = np.array([float(x) for x in line.split(":", 1)[1].split()])
        if params is None:
            raise ValueError(f"No Parameters line in {path}")
        if fixed is None:
            fixed = np.zeros(3)
        return params, fixed
    # binary .mat (AffineTransform_double_3_3): the last 12 + 3 little-endian
    # doubles are the parameters and the fixed parameters
    if len(raw) < 15 * 8:
        raise ValueError(f"Unrecognized ITK transform format: {path}")
    doubles = np.frombuffer(raw, dtype="<f8", offset=len(raw) - 15 * 8)
    return doubles[:12].copy(), doubles[12:15].copy()


def invert_itk(params: np.ndarray, fixed: np.ndarray):
    R = params[:9].reshape(3, 3)
    t = params[9:12]
    Rinv = np.linalg.inv(R)
    tinv = -Rinv @ t
    return np.concatenate([Rinv.reshape(-1), tinv]), fixed.copy()


_RAS_TO_LPS = np.diag([-1.0, -1.0, 1.0])


def get_4x4(mat: str | Path, img: str | Path, invert: bool = False,
            device="cuda") -> RigidTransform:
    """Rigid matrix relating a warped volume to a reference frame: the ITK
    transform expanded about its fixed centre, conjugated with the image's
    direction matrix (ITK/ANTs work in LPS; the canonical volume affine is
    RAS), translated by the negative volume centre, projected onto SO(3)."""
    params, fixed = read_itk_transform(mat)
    if invert:
        params, fixed = invert_itk(params, fixed)
    R = params[:9].reshape(3, 3)
    t = params[9:12]
    c = fixed[:3]
    global_t = -R @ c + t + c
    M = np.eye(4)
    M[:3, :3] = R
    M[:3, 3] = global_t

    data, affine = load_nifti(img)
    data, affine = to_canonical(data, affine)
    spacing = np.linalg.norm(affine[:3, :3], axis=0)
    direction = _RAS_TO_LPS @ (affine[:3, :3] / spacing)
    D = np.eye(4)
    D[:3, :3] = direction

    center_idx = (np.asarray(data.shape) - 1.0) / 2.0
    center = affine[:3, :3] @ center_idx + affine[:3, 3]
    Tinv = np.eye(4)
    Tinv[:3, 3] = -center

    T = Tinv @ D @ M @ np.linalg.inv(D)
    return project_onto_SO3(RigidTransform(torch.tensor(T, dtype=torch.float32, device=device)))


def ants_rigid_register(fix_filename, mov_filename, savepath):
    """Rigid CT-to-template registration through antspyx (optional;
    preprocessing only, never on the registration path)."""
    try:
        import ants  # type: ignore
    except ImportError as e:
        raise ImportError(
            "ants_rigid_register requires the optional 'antspyx' package "
            "(preprocessing only; not needed for training or registration)"
        ) from e
    img_fix = ants.image_read(str(fix_filename))
    img_mov = ants.image_read(str(mov_filename))
    result = ants.registration(
        img_fix,
        img_mov,
        type_of_transform="Rigid",
        aff_random_sampling_rate=0.666,
        aff_iterations=(200, 200, 50),
        aff_shrink_factors=(6, 4, 2),
        aff_smoothing_sigmas=(3, 2, 1),
    )
    transform = ants.read_transform(result["fwdtransforms"][0])
    ants.write_transform(transform, str(savepath))
