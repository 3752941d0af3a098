"""The golden trilinear DRR renderer, in plain PyTorch.

Counterpart of ``xvr_tpu.render.xla.raymarch_trilinear`` (the module keeps
its twin's name so the pair is easy to find). It consumes world-space ray
endpoints and a voxel->world affine and integrates true path lengths in mm
with a fixed-step midpoint rule and trilinear interpolation. PyTorch's
autograd gives its gradient. It is the oracle for the shear-warp kernels,
the ``trilinear_exact`` path, and the renderer kept when rays are too steep
for shear-warp.

Shapes: ``source`` (B, 1, 3) or (B, R, 3); ``target`` (B, R, 3) -> (B, R).
"""

from __future__ import annotations

import torch


def _apply_affine(A: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return pts @ A[:3, :3].T + A[:3, 3]


def _aabb_alphas(s: torch.Tensor, d: torch.Tensor, shape):
    """Entry/exit parameters of rays ``s + a * d`` with the voxel box
    ``[-0.5, n - 0.5]^3``, clipped to [0, 1]; empty hits give a_in >= a_out."""
    n = torch.tensor(shape, dtype=s.dtype, device=s.device)
    lo, hi = -0.5, n - 0.5
    parallel = torch.abs(d) < 1e-12
    safe_d = torch.where(parallel, torch.full_like(d, 1e-12), d)
    a1 = (lo - s) / safe_d
    a2 = (hi - s) / safe_d
    amin = torch.minimum(a1, a2)
    amax = torch.maximum(a1, a2)
    inside = (s > lo) & (s < hi)
    inf = torch.full_like(amin, float("inf"))
    amin = torch.where(parallel, torch.where(inside, -inf, inf), amin)
    amax = torch.where(parallel, torch.where(inside, inf, -inf), amax)
    a_in = torch.clamp(amin.max(dim=-1).values, 0.0, 1.0)
    a_out = torch.clamp(amax.min(dim=-1).values, 0.0, 1.0)
    return a_in, torch.maximum(a_out, a_in)


def trilinear_sample(grid: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of ``grid`` (nx, ny, nz) at voxel coordinates
    ``pts`` (..., 3); out-of-grid corners contribute zero."""
    nx, ny, nz = grid.shape
    p0 = torch.floor(pts)
    f = pts - p0
    p0 = p0.to(torch.int64)
    flat = grid.reshape(-1)
    out = torch.zeros(pts.shape[:-1], dtype=grid.dtype, device=grid.device)
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                ix, iy, iz = p0[..., 0] + cx, p0[..., 1] + cy, p0[..., 2] + cz
                valid = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & (iz >= 0) & (iz < nz)
                idx = (
                    ix.clamp(0, nx - 1) * (ny * nz) + iy.clamp(0, ny - 1) * nz + iz.clamp(0, nz - 1)
                )
                w = (
                    (f[..., 0] if cx else 1.0 - f[..., 0])
                    * (f[..., 1] if cy else 1.0 - f[..., 1])
                    * (f[..., 2] if cz else 1.0 - f[..., 2])
                )
                out = out + torch.where(valid, w, torch.zeros_like(w)) * flat[idx]
    return out


def raymarch_trilinear(
    density: torch.Tensor,
    affine_inverse: torch.Tensor,
    source: torch.Tensor,
    target: torch.Tensor,
    n_samples: int = 256,
    mask=None,
    labels=None,
    ray_chunk: int | None = None,
) -> torch.Tensor:
    """Fixed-step ray marching with trilinear interpolation (midpoint rule).

    Rays are processed in ``ray_chunk``-sized pieces when B * R * S is large,
    which bounds the (B, R, S, 3) sample tensors. Label channels are not
    ported yet (ROADMAP Queue 1, labelmap channels)."""
    if mask is not None and labels is not None:
        raise NotImplementedError(
            "label-channel rendering is not ported yet (ROADMAP Queue 1, labelmap channels)"
        )
    B, R = target.shape[0], target.shape[1]
    if ray_chunk is None and B * R * n_samples > 2**25:
        ray_chunk = max(1, 2**25 // (max(B, 1) * n_samples))
    if ray_chunk and ray_chunk < R:
        outs = [
            raymarch_trilinear(
                density, affine_inverse, source, target[:, r0 : r0 + ray_chunk],
                n_samples, ray_chunk=0,
            )
            for r0 in range(0, R, ray_chunk)
        ]
        return torch.cat(outs, dim=1)
    s_vox = _apply_affine(affine_inverse, source)
    t_vox = _apply_affine(affine_inverse, target)
    s_vox = s_vox.expand(t_vox.shape)
    d_vox = t_vox - s_vox
    raylen = torch.linalg.norm(target - source.expand(target.shape), dim=-1)

    a_in, a_out = _aabb_alphas(s_vox, d_vox, density.shape)  # (B, R)
    span = a_out - a_in
    k = (torch.arange(n_samples, dtype=density.dtype, device=density.device) + 0.5) / n_samples
    alphas = a_in[..., None] + span[..., None] * k  # (B, R, S)
    pts = s_vox[..., None, :] + alphas[..., None] * d_vox[..., None, :]
    vals = trilinear_sample(density, pts)
    step = span[..., None] / n_samples * raylen[..., None]
    return torch.sum(vals * step, dim=-1)
