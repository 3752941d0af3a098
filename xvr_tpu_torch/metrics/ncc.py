"""Image-similarity metrics: NCC, multiscale NCC, gradient NCC.

Counterpart of ``xvr_tpu.metrics.ncc``. Every metric takes (B, C, H, W)
batches and returns a per-item (B,) score in [-1, 1]. The JAX package
computes in f32; cuDNN would run the float32 convolutions in TF32, so the
convolutions here run with TF32 switched off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.device import device_constant
from ..utils.profiling import host_sync


def _moments(x: torch.Tensor):
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    var = x.var(dim=(1, 2, 3), keepdim=True, unbiased=False)
    return mean, var


def ncc(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Global normalized cross correlation, (B, C, H, W) -> (B,)."""
    mx, vx = _moments(x)
    my, vy = _moments(y)
    cov = ((x - mx) * (y - my)).mean(dim=(1, 2, 3))
    return cov / torch.sqrt(torch.clamp(vx[:, 0, 0, 0] * vy[:, 0, 0, 0], min=eps))


def _window_mean(x: torch.Tensor, p: int) -> torch.Tensor:
    """VALID p x p box mean over (B, C, H, W) -> (B, C, H-p+1, W-p+1)."""
    return F.avg_pool2d(x, kernel_size=p, stride=1)


def local_ncc(x: torch.Tensor, y: torch.Tensor, patch_size: int, eps: float = 1e-6) -> torch.Tensor:
    """Patchwise NCC averaged over all valid patch centres -> (B,).

    Both images are centred globally first (the one-pass covariance
    ``E[xy] - E[x]E[y]`` cancels badly in f32 when patch means dominate), the
    variance floor keeps flat patches finite, and the result is clamped."""
    p = int(patch_size)
    x = x - x.mean(dim=(1, 2, 3), keepdim=True)
    y = y - y.mean(dim=(1, 2, 3), keepdim=True)
    stacked = torch.cat([x, y, x * y, x * x, y * y], dim=1)
    mx, my, mxy, mxx, myy = torch.chunk(_window_mean(stacked, p), 5, dim=1)
    cov = mxy - mx * my
    vx = torch.clamp(mxx - mx * mx, min=0.0)
    vy = torch.clamp(myy - my * my, min=0.0)
    n = torch.clamp(cov / torch.sqrt((vx + eps) * (vy + eps)), -1.0, 1.0)
    return n.mean(dim=(1, 2, 3))


def multiscale_ncc(x, y, patch_sizes=(None, 9), patch_weights=(0.5, 0.5)) -> torch.Tensor:
    """Weighted mix of global and local NCC."""
    out = 0.0
    for p, w in zip(patch_sizes, patch_weights):
        out = out + w * (ncc(x, y) if p is None else local_ncc(x, y, int(p)))
    return out


_SOBEL_X = [[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]]


def _depthwise2d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Same-padded single-kernel depthwise cross-correlation over (B, C, H, W),
    in full f32 (TF32 off)."""
    C = x.shape[1]
    kh, kw = kernel.shape
    if kernel.device != x.device:
        host_sync(x)  # the kernel's copy from the host
    k = kernel.to(dtype=x.dtype, device=x.device).expand(C, 1, kh, kw)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return F.conv2d(x, k, padding=(kh // 2, kw // 2), groups=C)


_SOBEL = tuple(tuple(v / 8.0 for v in row) for row in _SOBEL_X)


def sobel(x: torch.Tensor) -> torch.Tensor:
    """Spatial gradients: (B, C, H, W) -> (B, 2C, H, W) [d/dx, d/dy]."""
    kx = device_constant(_SOBEL, x.dtype, x.device)
    ky = device_constant(tuple(zip(*_SOBEL)), x.dtype, x.device)
    return torch.cat([_depthwise2d(x, kx), _depthwise2d(x, ky)], dim=1)


def gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    if sigma <= 0:
        return x
    radius = max(int(3.0 * sigma + 0.5), 1)
    t = torch.arange(-radius, radius + 1, dtype=x.dtype)
    k1 = torch.exp(-0.5 * (t / sigma) ** 2)
    k1 = tuple((k1 / k1.sum()).tolist())
    k_row = device_constant((k1,), x.dtype, x.device)
    k_col = device_constant(tuple((v,) for v in k1), x.dtype, x.device)
    return _depthwise2d(_depthwise2d(x, k_row), k_col)


def gradient_ncc(x, y, patch_size: int = 11, sigma: float = 0.0) -> torch.Tensor:
    """Local NCC of Sobel gradients, optionally after a Gaussian blur."""
    return local_ncc(sobel(gaussian_blur(x, sigma)), sobel(gaussian_blur(y, sigma)), patch_size)


def make_imagesim(mncc_patch_size: int = 9, gncc_patch_size: int = 11, sigma: float = 0.0,
                  beta: float = 0.5):
    """``beta * mNCC + (1 - beta) * gNCC``, the registrar's similarity."""

    def imagesim(x, y):
        s = beta * multiscale_ncc(x, y, (None, mncc_patch_size), (0.5, 0.5))
        if beta < 1.0:
            s = s + (1.0 - beta) * gradient_ncc(x, y, gncc_patch_size, sigma)
        return s

    return imagesim
