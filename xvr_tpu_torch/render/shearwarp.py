"""Shear-warp DRR rendering on Hopper, with plain PyTorch twins.

Counterpart of ``xvr_tpu.render.shearwarp``. The trilinear line integral is
refactored in ray-slope space: rays are parametrized by their reduced slopes
``u = d_win / d_march`` and ``v = d_lane / d_march``; at volume slab
``m = k`` a ray sits at ``w = s_win + (k - s_march) u``,
``l = s_lane + (k - s_march) v``, which is affine in (u, v). So

1. **accumulate** (K1) builds the slope-space image
   ``I[b, i, j] = sum_k w_k sum_{w,l} hat(wpos - w) hat(lpos - l) S_k[w, l]``
   on a regular (u, v) grid, with ``w_k = clip(sgn (k - s_march) + 0.5, 0, 1)``;
2. **warp** (K2) resamples ``I`` bilinearly at each detector pixel's slope
   coordinates and scales by the path-length factor ``raylen / |d_march|``.

The backward pass (:class:`_FastRender`) is the analytic adjoint: warp
partials (K3), the warp transpose (a plain bilinear scatter-add) and the
source-position adjoint of the accumulate (K4). The slope grid, ``sgn`` and
``w_k`` are constants in the backward, as in the JAX package; the
source-to-detector [0, 1] clip is not applied (the volume lies between source
and detector in C-arm geometry).

The ``hat`` profile ``hat_eps(x) = clip(((1 + eps)/2 - |x|)/eps, 0, 1)`` is the
tent (trilinear) at ``eps = 1`` and a narrow trapezoid (the Siddon flavour) at
``eps = 0.25``.

**Kernels and plain versions.** :func:`accumulate`, :func:`warp`,
:func:`warp_with_grads` and :func:`accumulate_adjoint` dispatch on the device
of their tensors: on a CUDA tensor they launch the hand-written kernel
(``xvr_tpu_torch/csrc/shearwarp.cu``) or raise; on a CPU tensor they run the
plain PyTorch version beside them (:func:`_accumulate`, :func:`_warp_plain`,
:func:`_warp_with_grads_plain`, :func:`_accumulate_adjoint`). By default the
plain versions follow the JAX package's bf16 recipe (bf16 hat factors,
partial products and warp image, f32 accumulation), so the CPU path tracks
the JAX package to f32 round-off; with ``bf16=False`` they compute the
kernels' own arithmetic (f32, or float64 for a reference, from the bf16
volume), which is what the kernels are checked against on the card.

**Label channels.** With ``mask``/``labels`` the render has ``C = 1 +
len(labels)`` channels. :func:`prepare_shearwarp` stacks the full density and
the per-label masked densities; each channel accumulates (one K1 launch per
channel) over its own slab range (:func:`channel_slab_bounds`), the channels
fold into the warp's batch (K2 and K3 over C·B images), and the backward sums
the warp partials over the channels and runs K4 once per channel with its
bounds. The public channels are ``[background, labels...]``: channel 0 is
emitted as the full render minus the label sum, outside the autograd
Function, so that autograd carries that subtraction's cotangent into it.

**Content boxes.** The renderer's operand (:class:`ShearWarpOperand`,
``Projector.prepare``) is the volume with its content boxes: per channel
and slab, the rows and lanes that hold a nonzero bf16 value
(:func:`content_boxes`). K1 and K4 skip a (tile, slab) pair whose staged
box misses them: air, padding and a label channel outside its label would
add exactly +0.0, so the renders and gradients keep their bits. The boxes
go wherever the volume goes (every render and backward of a step, the
registrar's graph buffers, each slot of a mesh); a bare volume passed as
``prepared`` to the render gets them computed per call (:func:`as_operand`).
The plain versions read every slab.

``backward="slab"`` pairs the shear-warp forward with the slab kernel's VJP
(K6, :mod:`~xvr_tpu_torch.render.pallas`), as the JAX package's cross-check
does (single-channel only). ``grid_bounds = (u0, du, v0, dv, sgn)``, each
(B,), replaces the per-call fit of the slope grid and the march sign; fitted
to a full detector by :func:`shearwarp_grid_bounds`, it makes every ray block
of a ray-sharded render (:mod:`xvr_tpu_torch.parallel`) accumulate and warp
from the identical slope image. ``warp_window`` and
``warp_remap`` size TPU gather tiles; the GPU warp reads any grid cell, so
they are accepted and ignored.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils import profiling
from ..utils.device import device_constant
from ..utils.profiling import host_sync
from . import _cuda
from .layout import _choose_permutation

MAX_LANE = 1536  # slope-grid extent cap, as in the JAX package's warp

# K1/K4's slab tally, read by the spans' snapshot as two counters
profiling.add_device_counters(_cuda.zero_tallies, _cuda.read_tallies)


@dataclass(frozen=True)
class ShearWarpOperand:
    """The shear-warp renderer's volume operand: the permuted bf16 volume
    ``vol`` (M, Wd, L), or the (C, M, Wd, L) channel stack, and its
    :func:`content_boxes` ``boxes`` (C, M, 4) int32 (C = 1 for a volume)."""

    vol: torch.Tensor
    boxes: torch.Tensor

    def to(self, device) -> "ShearWarpOperand":
        return ShearWarpOperand(self.vol.to(device), self.boxes.to(device))

    def empty_like(self) -> "ShearWarpOperand":
        """A buffer of this operand's shapes (for :meth:`copy_`)."""
        return ShearWarpOperand(torch.empty_like(self.vol), torch.empty_like(self.boxes))

    def copy_(self, other: "ShearWarpOperand") -> "ShearWarpOperand":
        self.vol.copy_(other.vol)
        self.boxes.copy_(other.boxes)
        return self


def _content_boxes(vol: torch.Tensor) -> torch.Tensor:
    """Plain version of the content-box kernel: per slab of a (M, Wd, L)
    volume or a (C, M, Wd, L) stack, the first and last row and lane whose
    value is nonzero (-0.0 is zero) -> (C, M, 4) int32 ``(rlo, rhi, llo,
    lhi)``, ``(Wd, -1, L, -1)`` for a slab of zeros."""
    nz = (vol if vol.ndim == 4 else vol[None]) != 0

    def first_last(hit):
        n = hit.shape[-1]
        idx = torch.arange(n, dtype=torch.int32, device=hit.device)
        return (torch.where(hit, idx, n).amin(dim=-1),
                torch.where(hit, idx, -1).amax(dim=-1))

    rows, lanes = first_last(nz.any(dim=3)), first_last(nz.any(dim=2))
    return torch.stack([*rows, *lanes], dim=-1).to(torch.int32)


def content_boxes(vol: torch.Tensor) -> torch.Tensor:
    """The content boxes of a permuted bf16 volume or channel stack (see
    :func:`_content_boxes`): the kernel on a CUDA tensor, the plain version
    on a CPU one."""
    if _device_kind(vol) == "cpu":
        return _content_boxes(vol)
    return _cuda.content_boxes(vol.contiguous())


def as_operand(prepared) -> ShearWarpOperand:
    """``prepared`` as a :class:`ShearWarpOperand`; a bare permuted bf16
    volume or stack gets its content boxes computed here."""
    if isinstance(prepared, ShearWarpOperand):
        return prepared
    return ShearWarpOperand(prepared, content_boxes(prepared))


def prepare_shearwarp(density: torch.Tensor, perm, mask=None, labels=None) -> torch.Tensor:
    """Permute a density grid to (march, window, lane) order and cast bf16.
    O(volume): hoist out of optimization loops (``prepared=``, with its
    content boxes: ``Projector.prepare``).

    With ``mask``/``labels``: the (C, M, Wd, L) stack, C = 1 + len(labels),
    of the FULL density (channel 0) and the per-label masked densities."""
    vol = density.permute(*perm).contiguous().to(torch.bfloat16)
    if mask is None or labels is None:
        return vol
    m = mask.permute(*perm)
    fg = torch.stack([m == int(lab) for lab in labels]).to(torch.bfloat16)
    return torch.cat([vol[None], vol[None] * fg]).contiguous()


def channel_slab_bounds(mask, labels, perm, quantum: int = 16) -> tuple[tuple[int, int], ...]:
    """Per-channel march-axis slab ranges ``[k0, k1)`` of a channel render,
    on the host: channel 0 (the full density) spans every slab, each label
    channel the bounding range of its voxels along the permuted march axis,
    padded to ``quantum``. Slabs outside a label's range add exactly zero."""
    if isinstance(mask, torch.Tensor):
        host_sync(mask)
        mask = mask.detach().cpu().numpy()
    m = np.transpose(np.asarray(mask), perm)
    M = m.shape[0]
    out = [(0, M)]
    for lab in labels:
        hit = np.flatnonzero(np.any(m == lab, axis=(1, 2)))
        if hit.size == 0:
            out.append((0, min(quantum, M)))
            continue
        k0 = int(hit[0]) // quantum * quantum
        k1 = min(M, -(-(int(hit[-1]) + 1) // quantum) * quantum)
        out.append((k0, k1))
    return tuple(out)


def _hat(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Unit-mass trapezoid profile: tent at eps=1, box as eps -> 0."""
    return torch.clamp(((1.0 + eps) * 0.5 - torch.abs(x)) / eps, 0.0, 1.0)


def _hat_prime(x: torch.Tensor, eps: float) -> torch.Tensor:
    """d hat/dx: -sign(x)/eps on the ramps (1-eps)/2 < |x| < (1+eps)/2."""
    ax = torch.abs(x)
    on_ramp = (ax > (1.0 - eps) * 0.5) & (ax < (1.0 + eps) * 0.5)
    return torch.where(on_ramp, -torch.sign(x) / eps, torch.zeros_like(x))


def _grid_transform(lo, hi, n: int, eps: float = 1e-6):
    """Slope-grid origin/step covering [lo, hi] with a 2-cell interior margin."""
    step = torch.clamp(hi - lo, min=eps) / (n - 5)
    return lo - 2.0 * step, step


def default_grid_shape(det_shape: tuple[int, int]) -> tuple[int, int]:
    """Slope-grid resolution for a detector: detector-matched, padded to a
    multiple of 128, capped at 1536."""
    Hd, Wdet = det_shape
    Iu = min(max(-(-Hd // 128) * 128, 128), MAX_LANE)
    Iv = min(max(-(-Wdet // 128) * 128, 128), MAX_LANE)
    return Iu, Iv


def _params(s_p, sgn, u0, du, v0, dv) -> torch.Tensor:
    """(B, 8) f32 ``[s0, s1, s2, sgn, u0, du, v0, dv]`` for the kernels."""
    return torch.stack(
        [s_p[:, 0], s_p[:, 1], s_p[:, 2], sgn, u0, du, v0, dv], dim=1
    ).to(torch.float32).contiguous()


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"shear-warp runs on CPU (plain) or CUDA (kernels), not {x.device}")
    return x.device.type


# ---------------------------------------------------------------------------
# K1: slope-space accumulate
# ---------------------------------------------------------------------------


def _accumulate(vol, s_p, sgn, u0, du, v0, dv, *, Iu: int, Iv: int, eps: float = 1.0,
                k0: int = 0, k1: int | None = None, bf16: bool = True) -> torch.Tensor:
    """Plain version of K1 with dense per-slab hat matrices. ``vol`` (M, Wd, L)
    bf16; ``s_p`` (B, 3); the rest (B,) -> (B, Iu, Iv) in ``s_p``'s dtype.

    ``bf16=True`` is the JAX package's recipe (bf16 hat factors and partial
    product, f32 accumulation); ``bf16=False`` keeps every intermediate in
    ``s_p``'s dtype, the kernel's own arithmetic (a float64 ``s_p`` gives a
    reference for it)."""
    M, Wd, L = vol.shape
    k1 = M if k1 is None else k1
    dev, f = vol.device, s_p.dtype
    rnd = (lambda x: x.to(torch.bfloat16).to(f)) if bf16 else (lambda x: x)
    B = s_p.shape[0]
    iw = torch.arange(Wd, dtype=f, device=dev)
    il = torch.arange(L, dtype=f, device=dev)
    u = u0[:, None] + du[:, None] * torch.arange(Iu, dtype=f, device=dev)
    v = v0[:, None] + dv[:, None] * torch.arange(Iv, dtype=f, device=dev)
    s0, s1, s2 = s_p[:, 0], s_p[:, 1], s_p[:, 2]
    acc = torch.zeros((B, Iu, Iv), dtype=f, device=dev)
    for k in range(k0, k1):
        c = float(k) - s0
        w_pos = s1[:, None] + c[:, None] * u
        l_pos = s2[:, None] + c[:, None] * v
        wk = torch.clamp(sgn * c + 0.5, 0.0, 1.0)
        aw = rnd(rnd(_hat(w_pos[..., None] - iw, eps)) * rnd(wk)[:, None, None])
        bl = rnd(_hat(l_pos[..., None] - il, eps))
        t = aw @ vol[k].to(f)
        acc = acc + rnd(t) @ bl.transpose(1, 2)
    return acc


def accumulate(vol, s_p, sgn, u0, du, v0, dv, *, boxes, Iu: int, Iv: int, eps: float = 1.0,
               k0: int = 0, k1: int | None = None) -> torch.Tensor:
    """K1 on CUDA tensors, :func:`_accumulate` on CPU tensors. ``boxes``:
    the volume's (M, 4) content boxes, ``content_boxes(vol)[0]`` (the plain
    version reads every slab)."""
    if _device_kind(vol) == "cpu":
        return _accumulate(vol, s_p, sgn, u0, du, v0, dv, Iu=Iu, Iv=Iv, eps=eps, k0=k0, k1=k1)
    k1 = vol.shape[0] if k1 is None else k1
    return _cuda.accumulate(vol, _params(s_p, sgn, u0, du, v0, dv), boxes, Iu=Iu, Iv=Iv,
                            eps=eps, k0=k0, k1=k1)


# ---------------------------------------------------------------------------
# K4: source-position adjoint of the accumulate
# ---------------------------------------------------------------------------


def _contract_source(gw, gl, u0, du, v0, dv) -> torch.Tensor:
    """Per-row cotangent sums -> the 3-vector source adjoint g_s (B, 3).
    The sums cancel heavily, so they run in float64."""
    Iu, Iv = gw.shape[1], gl.shape[1]
    dev, f, d = gw.device, gw.dtype, torch.float64
    u = u0[:, None].to(d) + du[:, None].to(d) * torch.arange(Iu, dtype=d, device=dev)
    v = v0[:, None].to(d) + dv[:, None].to(d) * torch.arange(Iv, dtype=d, device=dev)
    gw, gl = gw.to(d), gl.to(d)
    g0 = -(gw * u).sum(1) - (gl * v).sum(1)
    return torch.stack([g0, gw.sum(1), gl.sum(1)], dim=-1).to(f)


def _accumulate_adjoint(vol, s_p, sgn, u0, du, v0, dv, Ibar, *, Iu: int, Iv: int,
                        eps: float = 1.0, k0: int = 0, k1: int | None = None,
                        bf16: bool = True) -> torch.Tensor:
    """Plain version of K4: d<Ibar, accumulate(...)>/d s_p with four dense
    products per slab -> g_s (B, 3). ``Ibar`` is read as bf16, as the kernel
    and the JAX package read it; ``bf16`` as in :func:`_accumulate`."""
    gw, gl = _adjoint_rows(vol, s_p, sgn, u0, du, v0, dv, Ibar, Iu=Iu, Iv=Iv, eps=eps, k0=k0,
                           k1=k1, bf16=bf16)
    return _contract_source(gw, gl, u0, du, v0, dv)


def _adjoint_rows(vol, s_p, sgn, u0, du, v0, dv, Ibar, *, Iu: int, Iv: int, eps: float = 1.0,
                  k0: int = 0, k1: int | None = None, bf16: bool = True):
    """The per-row cotangent sums of :func:`_accumulate_adjoint` before the
    contraction: gw (B, Iu) and gl (B, Iv), what the kernel returns."""
    M, Wd, L = vol.shape
    k1 = M if k1 is None else k1
    dev, f = vol.device, s_p.dtype
    rnd = (lambda x: x.to(torch.bfloat16).to(f)) if bf16 else (lambda x: x)
    B = s_p.shape[0]
    iw = torch.arange(Wd, dtype=f, device=dev)
    il = torch.arange(L, dtype=f, device=dev)
    u = u0[:, None] + du[:, None] * torch.arange(Iu, dtype=f, device=dev)
    v = v0[:, None] + dv[:, None] * torch.arange(Iv, dtype=f, device=dev)
    s0, s1, s2 = s_p[:, 0], s_p[:, 1], s_p[:, 2]
    ib = Ibar.to(torch.bfloat16).to(f)
    gw = torch.zeros((B, Iu), dtype=f, device=dev)
    gl = torch.zeros((B, Iv), dtype=f, device=dev)
    for k in range(k0, k1):
        c = float(k) - s0
        wk = torch.clamp(sgn * c + 0.5, 0.0, 1.0)
        dwu = (s1[:, None] + c[:, None] * u)[..., None] - iw  # (B, Iu, Wd)
        dlv = (s2[:, None] + c[:, None] * v)[..., None] - il  # (B, Iv, L)
        h, hp = rnd(_hat(dwu, eps)), rnd(_hat_prime(dwu, eps))
        bl, blp = rnd(_hat(dlv, eps)), rnd(_hat_prime(dlv, eps))
        S = vol[k].to(f)
        ga = rnd(ib @ bl) @ S.T  # (B, Iu, Wd)
        gw = gw + wk[:, None] * (ga * hp).sum(-1)
        gb = ib.transpose(1, 2) @ rnd(h @ S)  # (B, Iv, L)
        gl = gl + wk[:, None] * (gb * blp).sum(-1)
    return gw, gl


def accumulate_adjoint(vol, s_p, sgn, u0, du, v0, dv, Ibar, *, boxes, Iu: int, Iv: int,
                       eps: float = 1.0, k0: int = 0, k1: int | None = None) -> torch.Tensor:
    """K4 on CUDA tensors, :func:`_accumulate_adjoint` on CPU tensors;
    ``boxes`` as for :func:`accumulate`."""
    if _device_kind(vol) == "cpu":
        return _accumulate_adjoint(vol, s_p, sgn, u0, du, v0, dv, Ibar, Iu=Iu, Iv=Iv, eps=eps,
                                   k0=k0, k1=k1)
    k1 = vol.shape[0] if k1 is None else k1
    gw, gl = _cuda.accumulate_adjoint(
        vol, _params(s_p, sgn, u0, du, v0, dv), Ibar.to(torch.bfloat16).contiguous(), boxes,
        eps=eps, k0=k0, k1=k1,
    )
    return _contract_source(gw, gl, u0, du, v0, dv)


# ---------------------------------------------------------------------------
# K2/K3: the warp and its partials
# ---------------------------------------------------------------------------


def _warp_taps(I, uc, vc, ws, bf16: bool):
    """Shared gather of the plain warp: for rows z0 = floor(uc) and z0 + 1,
    (row weight masked by validity, tent slope, lo, hi), and the lane
    fraction. ``bf16=True`` reads the image as bf16, as the JAX package's
    warp reads its bf16-pair table; the CUDA kernels read it unrounded."""
    B, Iu, Iv = I.shape
    if bf16:
        I = I.to(torch.bfloat16).to(I.dtype)
    valid = (uc > -1.0) & (uc < Iu) & (vc >= 0.0) & (vc <= Iv - 1.0) & (ws > 0.0)
    vcs = torch.where(valid, vc, torch.zeros_like(vc))
    ucs = torch.where(valid, uc, torch.zeros_like(uc))
    idx = torch.clamp(vcs.to(torch.int64), 0, max(Iv - 2, 0))
    fx = torch.clamp(vcs - idx.to(vc.dtype), 0.0, 1.0)
    hi_idx = torch.clamp(idx + 1, max=Iv - 1)
    flat = I.reshape(B, Iu * Iv)
    z0 = torch.floor(ucs)
    taps = []
    for d in (0, 1):
        z = z0 + d
        inb = valid & (z >= 0) & (z < Iu)
        diff = ucs - z
        wz = torch.clamp(1.0 - torch.abs(diff), min=0.0)
        dz = torch.where(torch.abs(diff) < 1.0, -torch.sign(diff), torch.zeros_like(diff))
        zi = torch.clamp(z.to(torch.int64), 0, Iu - 1) * Iv
        lo = torch.gather(flat, 1, zi + idx)
        hi = torch.gather(flat, 1, zi + hi_idx)
        m = inb.to(I.dtype)
        taps.append((wz * m, dz * m, lo, hi))
    return taps, fx


def _warp_plain(I, uc, vc, ws, bf16: bool = True) -> torch.Tensor:
    """Plain version of K2: bilinear sample of I (B, Iu, Iv) at (uc, vc)
    (B, R), masked by validity, times ws -> (B, R)."""
    taps, fx = _warp_taps(I, uc, vc, ws, bf16)
    acc = sum(wz * (lo + fx * (hi - lo)) for wz, _, lo, hi in taps)
    return acc * ws


def _warp_with_grads_plain(I, uc, vc, ws, bf16: bool = True):
    """Plain version of K3: (bilerp, d bilerp/d uc, d bilerp/d vc), no ws."""
    taps, fx = _warp_taps(I, uc, vc, ws, bf16)
    val = sum(wz * (lo + fx * (hi - lo)) for wz, _, lo, hi in taps)
    dud = sum(dz * (lo + fx * (hi - lo)) for _, dz, lo, hi in taps)
    dvd = sum(wz * (hi - lo) for wz, _, lo, hi in taps)
    return val, dud, dvd


def warp(I, uc, vc, ws) -> torch.Tensor:
    """K2 on CUDA tensors, :func:`_warp_plain` on CPU tensors."""
    if _device_kind(I) == "cpu":
        return _warp_plain(I, uc, vc, ws)
    return _cuda.warp(I.contiguous(), uc.contiguous(), vc.contiguous(), ws.contiguous())


def warp_with_grads(I, uc, vc, ws):
    """K3 on CUDA tensors, :func:`_warp_with_grads_plain` on CPU tensors."""
    if _device_kind(I) == "cpu":
        return _warp_with_grads_plain(I, uc, vc, ws)
    return _cuda.warp_with_grads(I.contiguous(), uc.contiguous(), vc.contiguous(),
                                 ws.contiguous())


def _warp_transpose(gw, uc, vc, *, grid_shape) -> torch.Tensor:
    """Adjoint of the bilinear warp, a bilinear scatter-add of detector
    cotangents onto the grid: ``I_bar[b, i, j] = sum_p gw[p] tent(uc[p] - i)
    tent(vc[p] - j)``. No validity mask, as in the JAX package."""
    Iu, Iv = grid_shape
    B = gw.shape[0]
    bf16, f32 = torch.bfloat16, torch.float32
    u0, v0 = torch.floor(uc), torch.floor(vc)
    g16 = gw.to(bf16)
    out = torch.zeros((B, Iu * Iv), dtype=f32, device=gw.device)
    for a in (0, 1):
        i = u0 + a
        # the JAX package's bf16 factors: bf16(tent_u) * bf16(g) in bf16
        hu = (torch.clamp(1.0 - torch.abs(uc - i), min=0.0).to(bf16) * g16).to(f32)
        for c in (0, 1):
            j = v0 + c
            hv = torch.clamp(1.0 - torch.abs(vc - j), min=0.0).to(bf16).to(f32)
            ok = (i >= 0) & (i < Iu) & (j >= 0) & (j < Iv)
            flat = (torch.clamp(i, 0, Iu - 1) * Iv + torch.clamp(j, 0, Iv - 1)).to(torch.int64)
            out.scatter_add_(1, flat, torch.where(ok, hu * hv, torch.zeros_like(hu)))
    return out.reshape(B, Iu, Iv)


# ---------------------------------------------------------------------------
# Geometry glue
# ---------------------------------------------------------------------------


def _decompose(affine_inverse, source, target, perm):
    """World rays -> permuted voxel-space fields (s_p, d_p (B, R, 3), wscale (B, R))."""
    A = affine_inverse
    s_vox = source @ A[:3, :3].T + A[:3, 3]
    t_vox = target @ A[:3, :3].T + A[:3, 3]
    s_vox = s_vox.expand(t_vox.shape)
    d_vox = t_vox - s_vox
    raylen = torch.linalg.norm(target - source.expand(target.shape), dim=-1)
    order = device_constant(tuple(int(p) for p in perm), torch.int64, s_vox.device)
    s_p, d_p = s_vox.index_select(-1, order), d_vox.index_select(-1, order)
    wscale = raylen / torch.clamp(torch.abs(d_p[..., 0]), min=1e-6)
    return s_p, d_p, wscale


def _slope_pieces(d_p, Iu: int, Iv: int, bounds=None):
    """Per-ray slopes and the (constant, detached) slope-grid transform,
    fitted to these rays or, with ``bounds`` = (u0, du, v0, dv), given."""
    d0 = d_p[..., 0]
    safe_d0 = torch.where(torch.abs(d0) < 1e-6, torch.full_like(d0, 1e-6), d0)
    u = d_p[..., 1] / safe_d0
    v = d_p[..., 2] / safe_d0
    if bounds is None:
        u0, du = _grid_transform(u.min(dim=1).values, u.max(dim=1).values, Iu)
        v0, dv = _grid_transform(v.min(dim=1).values, v.max(dim=1).values, Iv)
    else:
        u0, du, v0, dv = bounds
    u0, du, v0, dv = (x.detach() for x in (u0, du, v0, dv))
    uc = (u - u0[:, None]) / du[:, None]
    vc = (v - v0[:, None]) / dv[:, None]
    return safe_d0, u0, du, v0, dv, uc, vc


def _march_sign(d_p, grid_bounds=None) -> torch.Tensor:
    if grid_bounds is not None:
        return grid_bounds[4].detach()
    return torch.sign(d_p[..., 0].mean(dim=1)).detach()


def _grid(d_p, Iu: int, Iv: int, grid_bounds=None):
    """(sgn, safe_d0, u0, du, v0, dv, uc, vc) of a render: the slope grid
    and march sign fitted to these rays, or ``grid_bounds``."""
    pieces = _slope_pieces(d_p, Iu, Iv, None if grid_bounds is None else grid_bounds[:4])
    return (_march_sign(d_p, grid_bounds), *pieces)


def shearwarp_grid_bounds(affine_inverse, source, target, *, perm, grid_shape):
    """The slope-grid transform and march sign of a full detector's rays ->
    ``(u0, du, v0, dv, sgn)``, each (B,) and detached. Passed as
    ``grid_bounds`` to the entry points, they make each ray block of a
    sharded render accumulate and warp against the identical slope grid, so
    that the blocks together equal the unsharded render."""
    Iu, Iv = grid_shape
    with torch.no_grad():
        _, d_p, _ = _decompose(affine_inverse, source, target, tuple(int(p) for p in perm))
        sgn, _, u0, du, v0, dv, _, _ = _grid(d_p, Iu, Iv)
    return u0, du, v0, dv, sgn


def _accumulate_any(prepared: ShearWarpOperand, s, sgn, u0, du, v0, dv, *, Iu: int, Iv: int,
                    eps: float, bounds=None) -> torch.Tensor:
    """K1 over a (M, Wd, L) volume -> (B, Iu, Iv), or once per channel of a
    (C, M, Wd, L) stack, each over its slab range ``bounds[c]`` ->
    (C, B, Iu, Iv)."""
    vol, boxes = prepared.vol, prepared.boxes
    kw = dict(Iu=Iu, Iv=Iv, eps=eps)
    if vol.ndim == 3:
        return accumulate(vol, s, sgn, u0, du, v0, dv, boxes=boxes[0], **kw)
    C, M = vol.shape[0], vol.shape[1]
    bounds = ((0, M),) * C if bounds is None else bounds
    return torch.stack([
        accumulate(vol[c], s, sgn, u0, du, v0, dv, k0=int(bounds[c][0]), k1=int(bounds[c][1]),
                   boxes=boxes[c], **kw)
        for c in range(C)
    ])


def _fold(I, *rays):
    """A (C, B, Iu, Iv) channel image and (B, R) ray fields -> the (C·B, ...)
    batch the warps take (every channel shares the warp coordinates)."""
    C, B = I.shape[0], I.shape[1]
    return (I.reshape(C * B, *I.shape[2:]), *(x.repeat(C, 1).contiguous() for x in rays))


def _render_fields(prepared, s_p, d_p, wscale, grid_shape, eps, chan_bounds=None,
                   grid_bounds=None):
    """Forward: accumulate (K1) then warp (K2). Returns (out, I): out (B, R),
    or (B, C, R) channels [full, labels...] for a channel stack."""
    Iu, Iv = grid_shape
    sgn, _, u0, du, v0, dv, uc, vc = _grid(d_p, Iu, Iv, grid_bounds)
    I = _accumulate_any(prepared, s_p[:, 0, :], sgn, u0, du, v0, dv, Iu=Iu, Iv=Iv, eps=eps,
                        bounds=chan_bounds)
    if I.ndim == 3:
        return warp(I, uc, vc, wscale), I
    C, B = I.shape[0], I.shape[1]
    out = warp(*_fold(I, uc, vc, wscale))
    return out.reshape(C, B, -1).transpose(0, 1), I


def _public_channels(out: torch.Tensor) -> torch.Tensor:
    """Channels [full, labels...] -> the public [background, labels...]:
    background = full - sum(labels) (exact: the labels are disjoint)."""
    if out.ndim != 3:
        return out
    return torch.cat([out[:, :1] - out[:, 1:].sum(dim=1, keepdim=True), out[:, 1:]], dim=1)


class _FastRender(torch.autograd.Function):
    """Shear-warp forward with the analytic shear-warp adjoint as backward
    (the counterpart of the JAX package's ``_fast_fwd``/``_fast_bwd``).
    ``grid_bounds`` are constants: they get no gradient."""

    @staticmethod
    def forward(ctx, prepared, affine_inverse, source, target, cfg, grid_bounds):
        grid_shape, perm, eps, _, chan_bounds = cfg
        s_p, d_p, wscale = _decompose(affine_inverse, source, target, perm)
        out, I = _render_fields(prepared, s_p, d_p, wscale, grid_shape, eps, chan_bounds,
                                grid_bounds)
        ctx.save_for_backward(prepared.vol, prepared.boxes, affine_inverse, source, target, I)
        ctx.cfg, ctx.grid_bounds = cfg, grid_bounds
        return out

    @staticmethod
    def backward(ctx, g):
        vol, boxes, affine_inverse, source, target, I = ctx.saved_tensors
        grid_shape, perm, eps, backward, chan_bounds = ctx.cfg
        Iu, Iv = grid_shape
        with torch.enable_grad():
            src = source.detach().requires_grad_(True)
            tgt = target.detach().requires_grad_(True)
            s_p, d_p, wscale = _decompose(affine_inverse, src, tgt, perm)
        if backward == "slab":
            # the slab kernel's VJP (K6) on the same bf16 table: the
            # gradient of the slab-marched integral, a cross-check
            from .pallas import _fields, slab_backward

            with torch.enable_grad():
                fields = _fields(s_p, d_p, wscale)
            g_fields = slab_backward(vol, fields.detach(), g.contiguous())
            g_src, g_tgt = torch.autograd.grad(fields, (src, tgt), g_fields)
            return None, None, g_src, g_tgt, None, None
        dp, ws = d_p.detach(), wscale.detach()
        sgn, safe_d0, u0, du, v0, dv, uc, vc = _grid(dp, Iu, Iv, ctx.grid_bounds)
        s = s_p[:, 0, :].detach()
        kw = dict(Iu=Iu, Iv=Iv, eps=eps)
        if I.ndim == 4:
            # channels fold into the warp batch; partials sum over C, and K4
            # runs once per channel over its slab range
            C, B = I.shape[0], I.shape[1]
            If, ucf, vcf, wsf = _fold(I, uc, vc, ws)
            gf = g.transpose(0, 1).reshape(C * B, -1).contiguous()
            bil, dWdu, dWdv = warp_with_grads(If, ucf, vcf, wsf)
            gwf = gf * wsf
            Ibar = _warp_transpose(gwf, ucf, vcf, grid_shape=grid_shape).reshape(C, B, Iu, Iv)

            def csum(x):
                return x.reshape(C, B, -1).sum(dim=0)

            g_ws, g_uc, g_vc = csum(gf * bil), csum(gwf * dWdu), csum(gwf * dWdv)
            cb = ((0, vol.shape[1]),) * C if chan_bounds is None else chan_bounds
            g_s_scalar = sum(
                accumulate_adjoint(vol[c], s, sgn, u0, du, v0, dv, Ibar[c], k0=int(cb[c][0]),
                                   k1=int(cb[c][1]), boxes=boxes[c], **kw)
                for c in range(C)
            )
        else:
            g = g.contiguous()
            bil, dWdu, dWdv = warp_with_grads(I, uc, vc, ws)
            gw = g * ws
            Ibar = _warp_transpose(gw, uc, vc, grid_shape=grid_shape)
            g_s_scalar = accumulate_adjoint(vol, s, sgn, u0, du, v0, dv, Ibar, boxes=boxes[0],
                                            **kw)
            g_ws, g_uc, g_vc = g * bil, gw * dWdu, gw * dWdv
        g_u = g_uc / du[:, None]
        g_v = g_vc / dv[:, None]
        g_d0 = -(g_u * dp[..., 1] + g_v * dp[..., 2]) / (safe_d0 * safe_d0)
        g_d = torch.stack([g_d0, g_u / safe_d0, g_v / safe_d0], dim=-1)
        g_s = torch.zeros_like(s_p)
        g_s[:, 0, :] = g_s_scalar
        g_src, g_tgt = torch.autograd.grad((s_p, d_p, wscale), (src, tgt), (g_s, g_d, g_ws))
        return None, None, g_src, g_tgt, None, None


def _resolve(density, affine_inverse, source, target, det_shape, perm, prepared, grid_shape,
             mask, labels):
    """Shared argument handling of the entry points."""
    if source.shape[-2] != 1:
        raise ValueError("shear-warp requires a point source: source (B, 1, 3)")
    if perm is None:
        host_sync(target, 2)
        d_mean = (target.mean(dim=(0, 1)) - source.mean(dim=(0, 1))).detach().cpu().numpy()
        A = affine_inverse.detach().cpu().numpy()
        perm = _choose_permutation(A[:3, :3] @ d_mean)
    perm = tuple(int(p) for p in perm)
    if prepared is None:
        prepared = prepare_shearwarp(density, perm, mask=mask, labels=labels)
    prepared = as_operand(prepared)
    if grid_shape is None:
        if det_shape is None:
            R = target.shape[1]
            side = int(round(np.sqrt(R)))
            if side * side != R:
                raise ValueError("det_shape required for non-square ray grids")
            det_shape = (side, side)
        grid_shape = default_grid_shape(det_shape)
    return perm, prepared, tuple(int(x) for x in grid_shape)


def _bounds(chan_bounds):
    return None if chan_bounds is None else tuple((int(a), int(b)) for a, b in chan_bounds)


def raymarch_trilinear_shearwarp(
    density, affine_inverse, source, target, det_shape=None, perm=None, prepared=None,
    grid_shape=None, warp_window: int = 48, unroll: int = 8, mask=None, labels=None,
    eps: float = 1.0, chan_bounds=None, warp_remap: bool = False, grid_bounds=None,
) -> torch.Tensor:
    """Forward-only shear-warp trilinear DRR: (B, R) line integrals in mm,
    or (B, C, R) channels [background, labels...] with ``mask``/``labels``
    (or a channel stack as ``prepared``); ``chan_bounds`` from
    :func:`channel_slab_bounds` restricts each label channel to its slabs.

    ``source`` (B, 1, 3) (a point source) and ``target`` (B, R, 3) in world
    mm. ``grid_bounds`` as in :func:`shearwarp_grid_bounds`. ``warp_window``,
    ``unroll`` and ``warp_remap`` are accepted for signature parity and
    ignored."""
    perm, prepared, grid_shape = _resolve(
        density, affine_inverse, source, target, det_shape, perm, prepared, grid_shape,
        mask, labels,
    )
    with torch.no_grad():
        s_p, d_p, wscale = _decompose(affine_inverse, source, target, perm)
        out = _render_fields(prepared, s_p, d_p, wscale, grid_shape, float(eps),
                             _bounds(chan_bounds), grid_bounds)[0]
        return _public_channels(out)


def raymarch_siddon_shearwarp(*args, eps: float = 0.25, **kwargs) -> torch.Tensor:
    """Forward-only Siddon-flavoured shear-warp render (trapezoid eps=0.25)."""
    return raymarch_trilinear_shearwarp(*args, eps=eps, **kwargs)


def raymarch_trilinear_fast(
    density, affine_inverse, source, target, det_shape=None, perm=None, prepared=None,
    packed=None, grid_shape=None, warp_window: int = 48, slab_window: int = 32,
    unroll: int = 8, backward: str = "shearwarp", mask=None, labels=None, eps: float = 1.0,
    chan_bounds=None, warp_remap: bool = False, grid_bounds=None,
) -> torch.Tensor:
    """Differentiable fast trilinear render: the shear-warp forward (K1, K2)
    with the analytic shear-warp adjoint (K3, warp transpose, K4) as its
    backward, or with ``backward="slab"`` the slab kernel's VJP (K6), a
    cross-check (single-channel only). Gradients flow to ``source`` and
    ``target``; ``grid_bounds`` (:func:`shearwarp_grid_bounds`) are constants.
    Channels as in :func:`raymarch_trilinear_shearwarp`.
    ``packed`` and ``slab_window`` are accepted for signature parity: both
    backwards read ``prepared``."""
    if backward not in ("shearwarp", "slab"):
        raise ValueError(f"unknown backward {backward!r}")
    perm, prepared, grid_shape = _resolve(
        density, affine_inverse, source, target, det_shape, perm, prepared, grid_shape,
        mask, labels,
    )
    if prepared.vol.ndim == 4 and backward == "slab":
        raise ValueError("backward='slab' does not support channel rendering")
    cfg = (grid_shape, perm, float(eps), backward, _bounds(chan_bounds))
    return _public_channels(
        _FastRender.apply(prepared, affine_inverse, source, target, cfg, grid_bounds))


def raymarch_siddon_fast(*args, eps: float = 0.25, **kwargs) -> torch.Tensor:
    """Differentiable Siddon-flavoured fast render (trapezoid eps=0.25)."""
    return raymarch_trilinear_fast(*args, eps=eps, **kwargs)
