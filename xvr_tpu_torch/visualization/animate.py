"""Re-render a saved optimization trajectory to video.

Counterpart of ``xvr_tpu.visualization.animate``: reload the self-describing
result bundle, rebuild the projector from its config, walk the trajectory
rows re-rendering each recorded pose (advancing the multiscale pyramid where
the recorded learning rate jumps back up, a stage boundary), and write the
frames to a video with imageio. :func:`render_trajectory` is the re-rendering
half, on any device; :func:`animate` adds the plotting half on the host.
Matplotlib and imageio are imported only when :func:`animate` is called.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..geometry import convert
from ..io.volumes import read
from ..io.xray import read_xray
from ..registrar.base import _parse_scales
from ..render.projector import Projector
from ..utils.transforms import make_xray_transforms


def load_bundle(inpath):
    """A result bundle (its directory or its ``parameters.npz``) -> (arrays,
    the ``parameters.json`` config)."""
    inpath = Path(inpath)
    if inpath.is_dir():
        npz, meta = inpath / "parameters.npz", inpath / "parameters.json"
    else:
        npz, meta = inpath, inpath.parent / "parameters.json"
    arrays = dict(np.load(npz))
    meta = json.loads(meta.read_text())
    return arrays, meta


def rebuild_projector(meta, device="cuda") -> Projector:
    """The bundle's projector (volume, intrinsics, renderer) on ``device``."""
    drr = meta["drr"]
    vol = read(
        drr["volume"], drr.get("mask"), labels=drr.get("labels"),
        orientation=drr.get("orientation"), device=device,
    )
    return Projector.from_volume(
        vol,
        sdd=drr["sdd"], height=int(drr["height"]), delx=drr["delx"],
        width=int(drr["width"]), dely=drr["dely"], x0=drr["x0"], y0=drr["y0"],
        reverse_x_axis=drr["reverse_x_axis"],
        # "<family>_exact" is the registrar's pin of the golden renderer
        renderer=drr["renderer"].removesuffix("_exact"),
        voxel_shift=drr.get("drr_kwargs", {}).get("voxel_shift", 0.0),
    )


def render_trajectory(inpath, skip: int = 1, device="cuda") -> list[tuple[int, np.ndarray, np.ndarray]]:
    """Re-render every ``skip``-th recorded pose of a bundle's trajectory on
    ``device`` at its pyramid stage's detector. -> one (iteration, DRR
    (H, W), X-ray (H, W)) per frame, as NumPy; H, W are the stage's, and the
    X-ray passes through the stage's X-ray transforms."""
    arrays, meta = load_bundle(inpath)
    projector = rebuild_projector(meta, device)
    xray_meta = meta["xray"]
    gt, *_ = read_xray(
        xray_meta["filename"],
        crop=int(xray_meta["crop"]),
        subtract_background=bool(xray_meta["subtract_background"]),
        linearize=bool(xray_meta["linearize"]),
        reducefn=xray_meta["reducefn"],
    )
    gt = torch.as_tensor(gt, device=device)

    params = arrays["trajectory_params"]  # (T, 6): euler ZXY (rad), xyz (mm)
    lrs = arrays["trajectory_lrs"]
    scales = _parse_scales(
        [str(s) for s in meta["optimization"]["scales"]],
        int(xray_meta["crop"]),
        int(meta["drr"]["height"]),
    )

    # stage boundaries: the recorded lr jumping UP starts the next stage
    stage_idx = 0
    proj_stage = projector.rescale_detector(scales[0])
    frames, panels = [], {}
    prev_lr = np.inf
    for t in range(0, len(params), skip):
        lr = lrs[min(t, len(lrs) - 1), 0]
        if lr > prev_lr and stage_idx + 1 < len(scales):
            stage_idx += 1
            proj_stage = projector.rescale_detector(scales[stage_idx])
        prev_lr = lr

        pose = convert(
            torch.as_tensor(params[t, :3], dtype=torch.float32, device=device)[None],
            torch.as_tensor(params[t, 3:], dtype=torch.float32, device=device)[None],
            parameterization="euler_angles", convention="ZXY",
        )
        with torch.no_grad():
            img = proj_stage(pose)[0, 0].cpu().numpy()
            if img.shape not in panels:
                tr = make_xray_transforms(img.shape[0], img.shape[1])
                panels[img.shape] = tr(gt)[0, 0].cpu().numpy()
        frames.append((t, img, panels[img.shape]))
    return frames


def animate(inpath, outpath, skip: int = 1, dpi: int = 192, fps: int = 30, device="cuda"):
    """Write the re-rendered trajectory (:func:`render_trajectory`) beside
    the X-ray as a video at ``outpath``; where imageio has no video backend,
    an animated GIF beside it. -> the path written."""
    import imageio.v3 as iio
    import matplotlib.pyplot as plt

    frames = []
    for t, img, gt_small in render_trajectory(inpath, skip, device):
        fig, axs = plt.subplots(ncols=2, figsize=(6, 3), dpi=dpi)
        for ax, im, name in zip(axs, [img, gt_small], [f"DRR (itr {t})", "X-ray"]):
            ax.imshow(im, cmap="gray")
            ax.set_title(name)
            ax.set_xticks([])
            ax.set_yticks([])
        fig.canvas.draw()
        frames.append(np.asarray(fig.canvas.buffer_rgba())[..., :3])
        plt.close(fig)

    outpath = Path(outpath)
    outpath.parent.mkdir(parents=True, exist_ok=True)
    stack = np.stack(frames)
    try:
        iio.imwrite(outpath, stack, fps=fps)
    except (OSError, TypeError):
        if outpath.suffix == ".gif":
            raise
        # no video backend (imageio-ffmpeg or pyav): an animated GIF instead
        outpath = outpath.with_suffix(".gif")
        iio.imwrite(outpath, stack, duration=1000.0 / fps, loop=0)
        print(f"No video backend for {fps} fps video; wrote {outpath}", flush=True)
    return outpath
