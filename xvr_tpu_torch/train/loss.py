"""Composite pose-regression training loss: counterpart of
``xvr_tpu.train.loss``. Per sample ``w_ncc (1 - mNCC) + w_dice Dice +
w_geo doubleGeodesic``, averaged with per-sample ``keep`` weights (a dropped
sample adds no loss and no gradient), plus an optional multiview-consistency
(mvc) term over all kept pose pairs."""

from __future__ import annotations

import torch

from ..geometry.se3 import RigidTransform
from ..metrics.dice import dice_loss
from ..metrics.geodesic import double_geodesic
from ..metrics.ncc import multiscale_ncc


def _weighted_mean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x * w).sum() / torch.clamp(w.sum(), min=1e-6)


def pose_regression_loss(
    img: torch.Tensor,  # (B, 1, H, W) normalized target DRRs
    mask: torch.Tensor | None,  # (B, C, H, W) target foreground masks (or None)
    pose: RigidTransform,  # (B,) ground-truth poses
    pred_img: torch.Tensor,
    pred_mask: torch.Tensor | None,
    pred_pose: RigidTransform,
    keep: torch.Tensor,  # (B,) 0/1 sample weights
    sdd: float,
    weight_ncc: float = 1.0,
    weight_geo: float = 1e-2,
    weight_dice: float = 1.0,
    weight_mvc: float = 0.0,
):
    """-> (scalar loss, dict of scalar metrics)."""
    mncc = multiscale_ncc(img, pred_img, (None, 9), (0.5, 0.5))
    if mask is not None and pred_mask is not None and mask.shape[1] > 1:
        dice = dice_loss(mask, pred_mask)
    else:
        dice = torch.zeros_like(mncc)
    rgeo, tgeo, dgeo = double_geodesic(pose, pred_pose, sdd)
    per_sample = weight_ncc * (1.0 - mncc) + weight_dice * dice + weight_geo * dgeo
    loss = _weighted_mean(per_sample, keep)

    # multiview consistency over all pose pairs: built only with weight
    if weight_mvc > 0:
        B = mncc.shape[0]
        iu, ju = torch.triu_indices(B, B, offset=1, device=keep.device)
        inv_true = RigidTransform(pose.matrix[iu]).inverse().matrix
        inv_pred = RigidTransform(pred_pose.matrix[iu]).inverse().matrix
        rel_true = RigidTransform(pose.matrix[ju] @ inv_true)
        rel_pred = RigidTransform(pred_pose.matrix[ju] @ inv_pred)
        *_, mvc_per_pair = double_geodesic(rel_true, rel_pred, sdd)
        mvc = _weighted_mean(mvc_per_pair, keep[iu] * keep[ju])
        loss = loss + weight_mvc * mvc
    else:
        mvc = torch.zeros((), dtype=loss.dtype, device=loss.device)

    metrics = {
        "mncc": _weighted_mean(mncc, keep),
        "dgeo": _weighted_mean(dgeo, keep),
        "rgeo": _weighted_mean(rgeo, keep),
        "tgeo": _weighted_mean(tgeo, keep),
        "dice": _weighted_mean(dice, keep),
        "mvc": mvc,
        "kept": keep.mean(),
    }
    return loss, metrics
