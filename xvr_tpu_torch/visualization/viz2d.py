"""2D visualization helpers (matplotlib, on the host).

Counterpart of ``xvr_tpu.visualization.viz2d``: ``plot_drr`` and
``plot_mask`` draw batches of DRRs and mask overlays, ``plot_registration``
the predicted, true and error DRRs with the projected fiducials and the
mTRE. Matplotlib is imported only when one of them is called.
"""

from __future__ import annotations

import numpy as np
import torch


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def plot_drr(imgs, axs=None, title=None, ticks=True, cmap="gray"):
    """Plot a batch of DRRs (B, 1, H, W) on a row of axes."""
    import matplotlib.pyplot as plt

    imgs = _numpy(imgs)
    if imgs.ndim == 3:
        imgs = imgs[None]
    B = imgs.shape[0]
    if axs is None:
        _, axs = plt.subplots(ncols=B, figsize=(3 * B, 3))
        if B == 1:
            axs = [axs]
    for ax, img in zip(np.ravel(axs), imgs):
        ax.imshow(img[0], cmap=cmap)
        if title:
            ax.set_title(title)
        if not ticks:
            ax.set_xticks([])
            ax.set_yticks([])
    return axs


def plot_mask(masks, axs, alpha=0.25, colors=("tab:red", "tab:blue", "tab:green", "tab:orange")):
    """Overlay foreground mask channels (B, C, H, W) on existing axes."""
    import matplotlib.colors as mcolors

    masks = _numpy(masks)
    for ax, m in zip(np.ravel(axs), masks):
        for c in range(m.shape[0]):
            color = mcolors.to_rgba(colors[c % len(colors)])
            overlay = np.zeros(m.shape[-2:] + (4,))
            overlay[..., :3] = color[:3]
            overlay[..., 3] = alpha * (m[c] > 0)
            ax.imshow(overlay)
    return axs


def plot_registration(projector, fiducials, true_pose, pred_pose, save_path=None):
    """Side-by-side predicted, true and error DRRs with the projected
    fiducials, titled with the mTRE."""
    import matplotlib.pyplot as plt

    from ..metrics.evaluator import Evaluator

    ev = Evaluator(projector, fiducials)
    with torch.no_grad():
        metrics = _numpy(ev(true_pose, pred_pose))
        pred_img = _numpy(projector(pred_pose))
        true_img = _numpy(projector(true_pose))
        pts_pred = _numpy(projector.perspective_projection(pred_pose, ev.fiducials))[0]
        pts_true = _numpy(projector.perspective_projection(true_pose, ev.fiducials))[0]
    mtre = float(metrics[..., 2] if metrics.ndim else metrics)

    fig, axs = plt.subplots(ncols=3, figsize=(9, 3))
    for ax, img, name in zip(
        axs, [pred_img, true_img, pred_img - true_img], ["Predicted", "Ground truth", "Error"]
    ):
        ax.imshow(img.squeeze(), cmap="gray")
        ax.set_title(name)
        ax.set_xticks([])
        ax.set_yticks([])
    axs[0].scatter(pts_pred[:, 0], pts_pred[:, 1], c="tab:orange", s=8)
    axs[1].scatter(pts_true[:, 0], pts_true[:, 1], c="tab:blue", s=8)
    fig.suptitle(f"mTRE = {mtre:.2f} mm")
    if save_path is not None:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    return fig
