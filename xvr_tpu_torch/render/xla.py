"""The golden DRR renderers (trilinear and Siddon), in plain PyTorch.

Counterpart of ``xvr_tpu.render.xla`` (the module keeps its twin's name so
the pair is easy to find). Both consume world-space ray endpoints and a
voxel->world affine and integrate true path lengths in mm: the trilinear one
with a fixed-step midpoint rule and trilinear interpolation, the Siddon one
as an exact incremental DDA over the voxel planes. PyTorch's autograd gives
their gradients. They are the oracles of the shear-warp and slab kernels, the
``trilinear_exact``/``siddon`` paths, and the renderers kept when rays are
too steep for the kernels.

Shapes: ``source`` (B, 1, 3) or (B, R, 3); ``target`` (B, R, 3) -> (B, R),
or (B, C, R) with a labelmap and labels (channel 0 = labels outside the
list, channel 1 + k = ``labels[k]``, by the nearest voxel's label).
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


def nearest_label(mask: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Nearest-voxel labelmap lookup at voxel coordinates (round half to
    even, as ``jnp.round``); out of the grid -> 0."""
    nx, ny, nz = mask.shape
    idx = torch.round(pts).to(torch.int64)
    valid = (
        (idx[..., 0] >= 0) & (idx[..., 0] < nx)
        & (idx[..., 1] >= 0) & (idx[..., 1] < ny)
        & (idx[..., 2] >= 0) & (idx[..., 2] < nz)
    )
    flat_idx = (
        idx[..., 0].clamp(0, nx - 1) * (ny * nz)
        + idx[..., 1].clamp(0, ny - 1) * nz
        + idx[..., 2].clamp(0, nz - 1)
    )
    lab = mask.reshape(-1)[flat_idx]
    return torch.where(valid, lab, torch.zeros_like(lab))


def _channel_weights(labels_sampled: torch.Tensor, labels) -> torch.Tensor:
    """(...,) integer labels -> (..., C) float32 one-hot over [background] + labels."""
    fg = torch.stack([labels_sampled == int(lab) for lab in labels], dim=-1)
    bg = ~fg.any(dim=-1, keepdim=True)
    return torch.cat([bg, fg], dim=-1).to(torch.float32)


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
    which bounds the (B, R, S, 3) sample tensors. With ``mask`` and
    ``labels`` each sample goes to the channel of its nearest voxel's label
    -> (B, C, R)."""
    B, R = target.shape[0], target.shape[1]
    if ray_chunk is None and B * R * n_samples > 2**25:
        ray_chunk = max(1, 2**25 // (max(B, 1) * n_samples))
    if ray_chunk and ray_chunk < R:
        outs = [
            raymarch_trilinear(
                density, affine_inverse, source, target[:, r0 : r0 + ray_chunk],
                n_samples, mask=mask, labels=labels, ray_chunk=0,
            )
            for r0 in range(0, R, ray_chunk)
        ]
        return torch.cat(outs, dim=-1)
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
    if mask is None or labels is None:
        return torch.sum(vals * step, dim=-1)
    w = _channel_weights(nearest_label(mask, pts), labels)  # (B, R, S, C)
    return torch.einsum("brs,brsc->bcr", vals * step, w)


def raymarch_siddon(
    density: torch.Tensor,
    affine_inverse: torch.Tensor,
    source: torch.Tensor,
    target: torch.Tensor,
    mask=None,
    labels=None,
    n_steps: int | None = None,
    unroll: int = 1,
) -> torch.Tensor:
    """Exact Siddon ray tracing as an incremental DDA.

    Every ray steps through its successive axis-plane crossings (planes at
    half-integer voxel coordinates) and accumulates ``density * segment
    length``; the loop runs the static bound nx + ny + nz + 3 steps (each
    step crosses at least one plane). Differentiable with respect to the ray
    endpoints through the crossing parameters; the voxel lookup is piecewise
    constant. ``unroll`` is accepted for signature parity and ignored."""
    nx, ny, nz = density.shape
    if n_steps is None:
        n_steps = nx + ny + nz + 3
    s_vox = _apply_affine(affine_inverse, source)
    t_vox = _apply_affine(affine_inverse, target)
    s_vox = s_vox.expand(t_vox.shape)
    d = t_vox - s_vox
    raylen = torch.linalg.norm(target - source.expand(target.shape), dim=-1)
    a_in, a_out = _aabb_alphas(s_vox, d, density.shape)

    parallel = torch.abs(d) < 1e-12
    safe_d = torch.where(parallel, torch.full_like(d, 1e-12), d)
    dalpha = 1.0 / torch.abs(safe_d)  # (B, R, 3) alpha step between crossings
    # first plane crossing strictly after a_in, per axis (planes at i + 0.5)
    pos_in = s_vox + a_in[..., None] * d
    next_plane = torch.where(
        d >= 0, torch.floor(pos_in - 0.5) + 1.5, torch.ceil(pos_in + 0.5) - 1.5
    )
    a_axis = (next_plane - s_vox) / safe_d
    a_axis = torch.where(parallel, torch.full_like(a_axis, float("inf")), a_axis)

    channels = mask is not None and labels is not None
    flat = density.reshape(-1)
    alpha, accum = a_in, None
    for _ in range(n_steps):
        a_next = torch.minimum(torch.amin(a_axis, dim=-1), a_out)
        seg = torch.clamp(a_next - alpha, min=0.0)
        midpt = s_vox + (0.5 * (alpha + a_next))[..., None] * d
        idx = torch.round(midpt).to(torch.int64)
        flat_idx = (
            idx[..., 0].clamp(0, nx - 1) * (ny * nz)
            + idx[..., 1].clamp(0, ny - 1) * nz
            + idx[..., 2].clamp(0, nz - 1)
        )
        contrib = torch.where(seg > 0, flat[flat_idx] * seg, torch.zeros_like(seg))
        if channels:
            w = _channel_weights(nearest_label(mask, midpt), labels)  # (B, R, C)
            contrib = (contrib[..., None] * w).movedim(-1, 1)  # (B, C, R)
        accum = contrib if accum is None else accum + contrib
        # advance every axis whose crossing was just consumed
        a_axis = torch.where(a_axis <= a_next[..., None] + 1e-9, a_axis + dalpha, a_axis)
        alpha = torch.maximum(alpha, a_next)
    if channels:
        return accum * raylen[:, None]
    return accum * raylen
