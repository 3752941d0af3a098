"""X-ray augmentation pipeline: counterpart of ``xvr_tpu.train.augmentations``.

Standardize -> CLAHE -> gamma -> box blur -> Gaussian noise -> sharpness ->
erasing -> random centre crop (collimation), each applied per sample with
probability ``p``, with the JAX package's ranges. Every op is split into its
random draws (:func:`draw_augmentations`, from an explicit
``torch.Generator``) and a deterministic body that takes them
(:func:`apply_augmentations`), so that equal draws give equal images in both
packages. The pipeline runs on rendered DRRs, which carry no gradient.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..metrics.ncc import _depthwise2d
from ..utils.transforms import standardize

ERASE_SCALE = (0.02, 0.33)
ERASE_RATIO = (0.3, 3.3)


# -- CLAHE -------------------------------------------------------------------


def _clahe_corner_plan(H: int, W: int, grid: int):
    """Host-side plan of the half-tile-cell CLAHE interpolation (the JAX
    package's): the pixels of one (th/2, tw/2) cell share four corner tiles,
    only their bilinear weights differ. -> (corner tile rows (C2, 4), corner
    tile columns (C2, 4), per-pixel corner weights (C2, P2, 4) f32,
    (cy, cx, th2, tw2)); corners in the order 00, 01, 10, 11."""
    th, tw = H // grid, W // grid
    th2, tw2 = th // 2, tw // 2

    def axis_plan(n_px, tile, half):
        cells = n_px // half
        lo = np.zeros(cells, np.int64)
        hi = np.zeros(cells, np.int64)
        frac = np.zeros((cells, half), np.float64)
        for ci in range(cells):
            px = ci * half + np.arange(half)
            yy = (px + 0.5) / tile - 0.5
            y0 = np.clip(np.floor(yy).astype(np.int64), 0, grid - 1)
            lo[ci] = y0[0]
            hi[ci] = min(y0[0] + 1, grid - 1)
            frac[ci] = np.clip(yy - y0, 0.0, 1.0)
        return lo, hi, frac

    ylo, yhi, fy = axis_plan(H, th, th2)
    xlo, xhi, fx = axis_plan(W, tw, tw2)
    cy, cx = len(ylo), len(xlo)
    corner_y = np.broadcast_to(np.stack([ylo, ylo, yhi, yhi], 1)[:, None, :], (cy, cx, 4))
    corner_x = np.broadcast_to(np.stack([xlo, xhi, xlo, xhi], 1)[None, :, :], (cy, cx, 4))
    wy = np.stack([1.0 - fy, 1.0 - fy, fy, fy], -1)  # (cy, th2, 4)
    wx = np.stack([1.0 - fx, fx, 1.0 - fx, fx], -1)  # (cx, tw2, 4)
    w = wy[:, None, :, None, :] * wx[None, :, None, :, :]
    w = w.reshape(cy * cx, th2 * tw2, 4).astype(np.float32)
    return corner_y.reshape(-1, 4), corner_x.reshape(-1, 4), w, (cy, cx, th2, tw2)


def clahe(x: torch.Tensor, clip_limit: torch.Tensor, grid: int = 8, n_bins: int = 64) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization of (B, 1, H, W)
    images in [0, 1], with the JAX package's plan: per-tile histograms of
    ``n_bins`` bins clipped at ``clip_limit * mean_count`` (excess spread
    evenly), and each pixel mapped through the bf16-rounded CDFs of its four
    corner tiles, weighted bilinearly by half-tile cell. ``clip_limit`` (B,)."""
    B, _, H, W = x.shape
    grid = max(min(grid, H // 2, W // 2), 1)
    q = 2 * grid
    if H % q or W % q:
        # reflect-pad to the cell quantum and crop back
        xp = torch.nn.functional.pad(x, (0, (-W) % q, 0, (-H) % q), mode="reflect")
        return clahe(xp, clip_limit, grid, n_bins)[..., :H, :W]
    th, tw = H // grid, W // grid
    xq = x[:, 0]
    tiles = xq.reshape(B, grid, th, grid, tw).permute(0, 1, 3, 2, 4).reshape(B, grid * grid, th * tw)
    idx = torch.clamp((tiles * n_bins).to(torch.int32), 0, n_bins - 1).long()
    hist = torch.zeros((B, grid * grid, n_bins), dtype=torch.float32, device=x.device)
    hist.scatter_add_(2, idx, torch.ones_like(tiles, dtype=torch.float32))

    limit = clip_limit.to(torch.float32)[:, None, None] * ((th * tw) / n_bins)
    excess = torch.clamp(hist - limit, min=0.0).sum(dim=-1, keepdim=True)
    hist = torch.minimum(hist, limit) + excess / n_bins
    cdf = torch.cumsum(hist, dim=-1)
    cdf = (cdf / cdf[..., -1:]).reshape(B, grid, grid, n_bins)

    corner_y, corner_x, w, (cy, cx, th2, tw2) = _clahe_corner_plan(H, W, grid)
    cy_t = torch.as_tensor(corner_y, device=x.device)
    cx_t = torch.as_tensor(corner_x, device=x.device)
    # (B, C2, 4, K): each cell's four corner CDFs, read as bf16 like the JAX
    # package's one-hot matmul reads them
    corner_cdf = cdf[:, cy_t, cx_t, :].to(torch.bfloat16).to(torch.float32)
    cells = xq.reshape(B, cy, th2, cx, tw2).permute(0, 1, 3, 2, 4).reshape(B, cy * cx, th2 * tw2)
    bins = torch.clamp((cells * n_bins).to(torch.int32), 0, n_bins - 1).long()
    vals = torch.gather(corner_cdf, 3, bins[:, :, None, :].expand(-1, -1, 4, -1))  # (B, C2, 4, P2)
    v = (vals.transpose(2, 3) * torch.as_tensor(w, device=x.device)[None]).sum(dim=-1)
    v = v.reshape(B, cy, cx, th2, tw2).permute(0, 1, 3, 2, 4).reshape(B, H, W)
    return v[:, None]


# -- simple photometric ops --------------------------------------------------

_BOX3 = torch.ones((3, 3)) / 9.0
_SHARP3 = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]]) / 13.0


def box_blur(x: torch.Tensor) -> torch.Tensor:
    return _depthwise2d(x, _BOX3.to(x.dtype))


def sharpness(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Blend towards an unsharp-masked image by ``factor`` (B,)."""
    smooth = _depthwise2d(x, _SHARP3.to(x.dtype))
    return x + factor[:, None, None, None] * (x - smooth)


def _grid(x: torch.Tensor):
    H, W = x.shape[-2:]
    yy = torch.arange(H, dtype=x.dtype, device=x.device)[None, :, None]
    xx = torch.arange(W, dtype=x.dtype, device=x.device)[None, None, :]
    return yy, xx


def random_erasing(x: torch.Tensor, area: torch.Tensor, log_r: torch.Tensor,
                   top_u: torch.Tensor, left_u: torch.Tensor) -> torch.Tensor:
    """Zero one rectangle per sample: ``area`` (B,) in pixels, ``log_r`` its
    log aspect ratio, ``top_u``/``left_u`` in [0, 1) its position within the
    room left."""
    H, W = x.shape[-2:]
    r = torch.exp(log_r)
    h = torch.clamp(torch.sqrt(area * r), 1, H)
    w = torch.clamp(torch.sqrt(area / r), 1, W)
    top = top_u * (H - h)
    left = left_u * (W - w)
    yy, xx = _grid(x)
    inside = ((yy >= top[:, None, None]) & (yy < (top + h)[:, None, None])
              & (xx >= left[:, None, None]) & (xx < (left + w)[:, None, None]))
    return torch.where(inside[:, None], torch.zeros_like(x), x)


def random_center_crop(x: torch.Tensor, crop: torch.Tensor) -> torch.Tensor:
    """Zero a border of ``crop`` (B,) pixels per sample (collimation)."""
    H, W = x.shape[-2:]
    yy, xx = _grid(x)
    c = crop.to(x.dtype)[:, None, None]
    inside = (yy >= c) & (yy < H - c) & (xx >= c) & (xx < W - c)
    return torch.where(inside[:, None], x, torch.zeros_like(x))


# -- the pipeline ------------------------------------------------------------


def draw_augmentations(generator: torch.Generator, shape, p: float = 0.333,
                       max_crop: int = 10) -> dict:
    """The random draws of :func:`apply_augmentations` for images of
    ``shape`` (B, 1, H, W), on ``generator``'s device: each op's per-sample
    choice (``take_*``, probability ``p``) and its parameters."""
    B, _, H, W = shape
    dev = generator.device

    def u(*size):
        return torch.rand(size, generator=generator, device=dev)

    def take():
        return u(B) < p

    d = {}
    d["clip"], d["take_clahe"] = 1.0 + 9.0 * u(B), take()
    d["gamma"], d["take_gamma"] = 0.7 + 1.1 * u(B), take()
    d["take_blur"] = take()
    d["noise"] = 0.01 * torch.randn(tuple(shape), generator=generator, device=dev)
    d["take_noise"] = take()
    d["factor"], d["take_sharp"] = 0.5 * u(B), take()
    lo, hi = math.log(ERASE_RATIO[0]), math.log(ERASE_RATIO[1])
    d["take_erase"] = take()
    d["erase_area"] = (ERASE_SCALE[0] + (ERASE_SCALE[1] - ERASE_SCALE[0]) * u(B)) * H * W
    d["erase_log_r"] = lo + (hi - lo) * u(B)
    d["erase_top"], d["erase_left"] = u(B), u(B)
    d["take_crop"] = take()
    d["crop"] = torch.randint(0, max_crop + 1, (B,), generator=generator, device=dev)
    return d


def apply_augmentations(x: torch.Tensor, d: dict) -> torch.Tensor:
    """The deterministic pipeline on (B, 1, H, W) images given the draws."""

    def maybe(take, x_aug, x):
        return torch.where(take.to(x.device)[:, None, None, None], x_aug, x)

    d = {k: v.to(x.device) for k, v in d.items()}
    x = standardize(x)
    x = maybe(d["take_clahe"], clahe(x, d["clip"]), x)
    x = maybe(d["take_gamma"], torch.clamp(x, min=1e-8) ** d["gamma"][:, None, None, None], x)
    x = maybe(d["take_blur"], box_blur(x), x)
    x = maybe(d["take_noise"], x + d["noise"].to(x.dtype), x)
    x = maybe(d["take_sharp"], sharpness(x, d["factor"]), x)
    x = maybe(d["take_erase"], random_erasing(x, d["erase_area"], d["erase_log_r"],
                                              d["erase_top"], d["erase_left"]), x)
    x = maybe(d["take_crop"], random_center_crop(x, d["crop"]), x)
    return x


def xray_augmentations(generator: torch.Generator, x: torch.Tensor, p: float = 0.333,
                       max_crop: int = 10) -> torch.Tensor:
    """The full pipeline on (B, 1, H, W) images with fresh draws."""
    return apply_augmentations(x, draw_augmentations(generator, x.shape, p, max_crop))
