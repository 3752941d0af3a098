"""Multi-channel 2D Dice coefficient and loss: counterpart of
``xvr_tpu.metrics.dice``. Channel 0 is the background and is left out; an
empty channel (0/0) is NaN in the coefficient and is skipped by the loss's
mean over channels (an image with no valid channel has loss 0)."""

from __future__ import annotations

import torch


def dice_coefficient(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) x2 -> (B, C-1) Dice per foreground channel (NaN if empty)."""
    B, C = y_pred.shape[:2]
    p = y_pred.reshape(B, C, -1)
    t = y_true.reshape(B, C, -1)
    inter = (p * t).sum(dim=2)
    denom = p.sum(dim=2) + t.sum(dim=2)
    return (2.0 * inter / denom)[:, 1:]


def dice_loss(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) x2 -> (B,) loss = 1 - mean Dice over the valid channels;
    0 where no channel is valid (or C <= 1)."""
    B, C = y_pred.shape[:2]
    if C <= 1:
        return torch.zeros((B,), dtype=y_pred.dtype, device=y_pred.device)
    p = y_pred.reshape(B, C, -1)
    t = y_true.reshape(B, C, -1)
    inter = (p * t).sum(dim=2)[:, 1:]
    denom = (p.sum(dim=2) + t.sum(dim=2))[:, 1:]
    valid = denom > 0
    dice = torch.where(valid, 2.0 * inter / torch.clamp(denom, min=1e-12), torch.zeros_like(denom))
    n_valid = valid.sum(dim=1)
    mean = dice.sum(dim=1) / torch.clamp(n_valid, min=1)
    return torch.where(n_valid > 0, 1.0 - mean, torch.zeros_like(mean))
