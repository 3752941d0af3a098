"""Image normalization transforms applied to every X-ray and DRR.

Counterpart of ``xvr_tpu.utils.transforms``: ``standardize`` (min-max) ->
optional differentiable histogram ``equalize`` -> ``resize`` ->
``normalize(mean=0.15, std=0.1)``. All functions take (B, C, H, W).
"""

from __future__ import annotations

import torch


def standardize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-batch-item min-max rescale to [0, 1]."""
    dims = tuple(range(1, x.ndim))
    lo = torch.amin(x, dim=dims, keepdim=True)
    hi = torch.amax(x, dim=dims, keepdim=True)
    return (x - lo) / (hi - lo + eps)


def equalize(x: torch.Tensor, n_bins: int = 256, tau: float = 0.01, eps: float = 1e-10,
             chunk: int = 8192) -> torch.Tensor:
    """Differentiable histogram equalization: pixels are soft-assigned to
    intensity bins with a Gaussian kernel of width ``tau``, the CDF is built
    and pixels are mapped through it. Pixels go in chunks to bound memory."""
    B, C, H, W = x.shape
    flat = x.reshape(B, -1)
    bins = torch.linspace(0.0, 1.0, n_bins, dtype=x.dtype, device=x.device)

    def weights_of(c):  # (B, p) -> (B, p, n_bins)
        return torch.exp(-((c[..., None] - bins) ** 2) / (2.0 * tau**2))

    chunks = torch.split(flat, chunk, dim=1)
    hist = sum(weights_of(c).sum(dim=1) for c in chunks)
    hist = hist / (hist.sum(dim=1, keepdim=True) + eps)
    cdf = torch.cumsum(hist, dim=1)
    cdf_n = (cdf - cdf[:, :1]) / (1.0 - cdf[:, :1] + eps)
    mapped = []
    for c in chunks:
        w = weights_of(c)
        w = w / (w.sum(dim=-1, keepdim=True) + eps)
        mapped.append(torch.einsum("bpn,bn->bp", w, cdf_n))
    return torch.cat(mapped, dim=1).reshape(B, C, H, W)


def _resize_weights(n_in: int, n_out: int, dtype, device) -> torch.Tensor:
    """(n_in, n_out) triangle-filter weights of an antialiased linear resize,
    computed as ``jax.image.resize(method="bilinear")`` computes them: the
    kernel widens by the downsampling factor, each output column is
    normalized, and samples outside the input are zeroed."""
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n_out, dtype=dtype, device=device) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(n_in, dtype=dtype, device=device)[:, None])
    w = torch.clamp(1.0 - x / kernel_scale, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(
        torch.abs(total) > 1000.0 * torch.finfo(torch.float32).eps,
        w / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(w),
    )
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Antialiased bilinear resize of (B, C, H, W) -> (B, C, height, width),
    in f32 (the JAX package resizes at HIGHEST precision)."""
    H, W = x.shape[-2:]
    if H != height:
        wh = _resize_weights(H, height, x.dtype, x.device)
        x = torch.einsum("bchw,ho->bcow", x, wh)
    if W != width:
        ww = _resize_weights(W, width, x.dtype, x.device)
        x = torch.einsum("bchw,wo->bcho", x, ww)
    return x


def normalize(x: torch.Tensor, mean: float = 0.15, std: float = 0.1) -> torch.Tensor:
    return (x - mean) / std


def make_xray_transforms(height: int, width: int | None = None, mean: float = 0.15,
                         std: float = 0.1, use_equalize: bool = False):
    """Composable pipeline: standardize -> [equalize] -> resize -> normalize."""
    width = height if width is None else width

    def transforms(x: torch.Tensor) -> torch.Tensor:
        x = standardize(x)
        if use_equalize:
            x = equalize(x)
        return normalize(resize(x, height, width), mean, std)

    return transforms


def center_crop(x: torch.Tensor, out_h: int, out_w: int | None = None) -> torch.Tensor:
    """Centre crop of (B, C, H, W), zero-padding when the crop is larger."""
    out_w = out_h if out_w is None else out_w
    H, W = x.shape[-2:]
    top = max((H - out_h) // 2, 0)
    left = max((W - out_w) // 2, 0)
    x = x[..., top : top + out_h, left : left + out_w]
    pad_h, pad_w = out_h - x.shape[-2], out_w - x.shape[-1]
    if pad_h or pad_w:
        x = torch.nn.functional.pad(
            x, (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2)
        )
    return x
