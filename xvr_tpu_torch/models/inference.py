"""Inference helpers: intrinsics-matched resampling and pose prediction.

Counterpart of ``xvr_tpu.models.inference``: an X-ray acquired at (sdd, delx,
x0, y0) is reprojected to the intrinsics the CNN was trained at, centre-
cropped square, normalized and passed through the network; the predicted
pose can be warped into the patient frame by an ITK/ANTs transform, and an
antipodal pose built to resolve the AP/PA flip. Tensors stay on the device
of the caller (the model's, for :func:`predict_pose`).
"""

from __future__ import annotations

import math

import torch

from ..geometry import RigidTransform, convert
from ..utils.itk import get_4x4
from ..utils.transforms import center_crop, make_xray_transforms


def resample(
    img: torch.Tensor,
    sdd: float,
    delx: float,
    x0: float,
    y0: float,
    new_sdd: float,
    new_delx: float,
    new_x0: float = 0.0,
    new_y0: float = 0.0,
) -> torch.Tensor:
    """Reproject an X-ray (B, C, H, W) to other detector intrinsics: a pixel
    at physical offset u subtends the angle atan(u / sdd), so matching angles
    gives ``u_old = u_new * sdd / new_sdd``; bilinear samples there, zero
    where they fall off the old detector."""
    B, C, H, W = img.shape
    i = torch.arange(H, dtype=img.dtype, device=img.device)
    j = torch.arange(W, dtype=img.dtype, device=img.device)
    v_new = (i - (H - 1) / 2.0) * new_delx + new_y0
    u_new = (j - (W - 1) / 2.0) * new_delx + new_x0
    v_old = v_new * (sdd / new_sdd) + y0
    u_old = u_new * (sdd / new_sdd) + x0
    ii = v_old / delx + (H - 1) / 2.0
    jj = u_old / delx + (W - 1) / 2.0

    ii0 = torch.clamp(torch.floor(ii), 0, H - 1)
    jj0 = torch.clamp(torch.floor(jj), 0, W - 1)
    fi = torch.clamp(ii - ii0, 0.0, 1.0)
    fj = torch.clamp(jj - jj0, 0.0, 1.0)
    i0 = ii0.long()
    j0 = jj0.long()
    i1 = torch.clamp(i0 + 1, 0, H - 1)
    j1 = torch.clamp(j0 + 1, 0, W - 1)

    def gather(ia, ja):
        return img[:, :, ia][:, :, :, ja]

    out = (
        gather(i0, j0) * ((1 - fi)[:, None] * (1 - fj)[None, :])
        + gather(i0, j1) * ((1 - fi)[:, None] * fj[None, :])
        + gather(i1, j0) * (fi[:, None] * (1 - fj)[None, :])
        + gather(i1, j1) * (fi[:, None] * fj[None, :])
    )
    valid = ((ii >= 0) & (ii <= H - 1))[:, None] & ((jj >= 0) & (jj <= W - 1))[None, :]
    return torch.where(valid[None, None], out, torch.zeros_like(out))


def _resample_xray(img, sdd, delx, dely, x0, y0, config, device="cuda"):
    """Match the model's intrinsics: its ``sdd``, and its ``delx`` at the
    X-ray's own pixel count. -> (img on ``device``, H, W)."""
    if abs(delx - dely) > 1e-9:
        raise ValueError("Non-square pixels are not yet supported")
    model_height = int(config["height"])
    model_delx = float(config["delx"])
    H, W = img.shape[-2:]
    subsample = min(H, W) / model_height
    new_delx = model_delx / subsample
    img = torch.as_tensor(img, dtype=torch.float32, device=device)
    img = resample(img, sdd, delx, x0, y0, float(config["sdd"]), new_delx, 0.0, 0.0)
    return img, H, W


def predict_pose(model, params, config, img, sdd, delx, dely, x0, y0):
    """-> (init_pose, preprocessed img), both on the model's device."""
    device = next(iter(params.values())).device
    img, height, width = _resample_xray(img, sdd, delx, dely, x0, y0, config, device)
    side = min(height, width)
    img = center_crop(img, side, side)
    x = make_xray_transforms(int(config["height"]))(img)
    with torch.no_grad():
        return model.predict_pose(params, x), x


def correct_pose(pose: RigidTransform, warp, volume, invert: bool) -> RigidTransform:
    """Warp the predicted pose from the template into the patient frame."""
    if warp is None:
        return pose
    T = get_4x4(warp, volume, invert, device=pose.device)
    return pose.compose(T)


def construct_antipode(pose: RigidTransform) -> RigidTransform:
    """The pose viewing from the opposite side (the PA/AP ambiguity): alpha
    and beta negated, then pi added to alpha."""
    rot, xyz = pose.convert("euler_angles", "ZXY")
    rot = rot.clone()
    rot[..., 0:2] *= -1.0
    rot[..., 0] += math.pi
    return convert(rot, xyz, parameterization="euler_angles", convention="ZXY")
