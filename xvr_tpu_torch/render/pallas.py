"""Slab-march DRR rendering on Hopper, with plain PyTorch twins.

Counterpart of ``xvr_tpu.render.pallas``; the module keeps its twin's name
so a reader finds the pair, but it holds no Pallas: its four kernels are
hand-written CUDA (``xvr_tpu_torch/csrc/slab.cu``).

A ray ``s + alpha d`` (voxel coordinates permuted to march, window, lane
order by ``perm``) is integrated at its crossings with the volume's march
planes, where interpolation is bilinear in the two transverse axes; each
plane's slab weight is trimmed to the ray's box entry/exit by the midpoint
rule, and the sum is scaled by ``ws = |ray| / |d_march|``.

* **K5** :func:`slab_forward`: the trilinear slab forward.
* **K6** :func:`slab_backward`: its analytic per-ray VJP with respect to the
  seven ray fields (the volume gets no gradient), through :class:`_SlabCore`.
* **K7** :func:`slab_channels`: K5 split into label channels by the nearest
  voxel's label; its backward is K6 on the mean cotangent
  (:class:`_SlabChannels`).
* **K8** :func:`slab_siddon`: the exact Siddon forward, forward only.

Each dispatches on the device of its tensors: on a CUDA tensor it launches
the kernel or raises; on a CPU tensor it runs the plain PyTorch version
beside it (:func:`_slab_forward`, :func:`_slab_backward`,
:func:`_slab_channels`, :func:`_slab_siddon`), which repeats the kernel's
arithmetic operation by operation (a float64 ``fields`` gives a reference).

Ray fields are one (7, B, R) tensor ``[s0, s1, s2, d0, d1, d2, ws]``, made by
:func:`_fields` from :func:`~xvr_tpu_torch.render.shearwarp._decompose`.

**TPU-only modes not carried over.** The GPU kernels read any row of the
plain bf16 (M, Wd, L) volume that ``pack_density`` makes (the same tensor as
``shearwarp.prepare_shearwarp``), which the H100 holds whole even at 512^3.
So there is no HBM streaming (``stream``), no static gather window or its
measurement (``window``, ``measured_window_span``), no barrel-shear ray
remap (``remap``) and no bf16 pair packing. Those arguments are accepted and
ignored; the JAX package's result equals this one whenever its window does
not clip.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda, xla
from .layout import _choose_permutation, choose_permutation_for_pose, measured_steepness
from .shearwarp import _decompose, _device_kind

__all__ = [
    "_choose_permutation",
    "choose_permutation_for_pose",
    "measured_steepness",
    "pack_density",
    "pack_labels",
    "packed_table_bytes",
    "raymarch_siddon_pallas",
    "raymarch_trilinear_pallas",
    "slab_backward",
    "slab_channels",
    "slab_forward",
    "slab_siddon",
]

BIG = 3e38  # "no crossing" sentinel of the Siddon kernel


def pack_density(density: torch.Tensor, perm) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """Permute a density grid to (march, window, lane) order and cast bf16
    -> (table, its shape). O(volume): hoist out of optimization loops and
    pass as ``packed``."""
    vol = density.permute(*perm).contiguous().to(torch.bfloat16)
    return vol, tuple(int(x) for x in vol.shape)


def pack_labels(mask: torch.Tensor, perm) -> torch.Tensor:
    """Permute an integer labelmap like :func:`pack_density` and clip it to
    uint8 0..255 (negative labels wrap to 255, as the JAX package's uint32
    cast then clip does)."""
    m = mask.permute(*perm).to(torch.int64)
    m = torch.where(m < 0, torch.full_like(m, 255), m.clamp(max=255))
    return m.to(torch.uint8).contiguous()


def packed_table_bytes(vol_shape_or_density, perm=None) -> int:
    """Bytes of the table :func:`pack_density` makes: the bf16 volume."""
    shape = getattr(vol_shape_or_density, "shape", vol_shape_or_density)
    if perm is not None:
        shape = [shape[a] for a in perm]
    M, Wd, L = (int(x) for x in shape)
    return M * Wd * L * 2


def _fields(s_p, d_p, wscale) -> torch.Tensor:
    """(B, R, 3), (B, R, 3), (B, R) -> the kernels' (7, B, R) fields."""
    return torch.cat([s_p.permute(2, 0, 1), d_p.permute(2, 0, 1), wscale[None]], 0).contiguous()


# ---------------------------------------------------------------------------
# Plain versions (the kernels' arithmetic, operation by operation)
# ---------------------------------------------------------------------------


def _full(x, v):
    return torch.full_like(x, v)


def _box(fields, shape):
    """Per-ray box entry/exit (a_in, a_out) in alpha, from 0 and 1."""
    a_in, a_out = torch.zeros_like(fields[0]), torch.ones_like(fields[0])
    for i, n in enumerate(shape):
        s, d = fields[i], fields[3 + i]
        parallel = torch.abs(d) < 1e-9
        safe = torch.where(parallel, _full(d, 1e-9), d)
        t1 = (-0.5 - s) / safe
        t2 = ((n - 0.5) - s) / safe
        lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
        inside = (s > -0.5) & (s < n - 0.5)
        lo = torch.where(parallel, torch.where(inside, _full(lo, -BIG), _full(lo, BIG)), lo)
        hi = torch.where(parallel, torch.where(inside, _full(hi, BIG), _full(hi, -BIG)), hi)
        a_in, a_out = torch.maximum(a_in, lo), torch.minimum(a_out, hi)
    return a_in, torch.maximum(a_out, a_in)


def _march(fields):
    """(safe_d0, inv_d0, abs_d0) of every ray."""
    d0 = fields[3]
    safe_d0 = torch.where(torch.abs(d0) < 1e-6, _full(d0, 1e-6), d0)
    return safe_d0, 1.0 / safe_d0, torch.abs(safe_d0)


def _positions(fields, k: int, inv_d0):
    """alpha, p1, p2 of plane k, each product and sum rounded on its own."""
    s0, s1, s2, _, d1, d2, _ = fields
    alpha = (float(k) - s0) * inv_d0
    return alpha, s1 + alpha * d1, s2 + alpha * d2


def _inside(p1, p2, Wd: int, L: int):
    return (p1 > -1.0) & (p1 < Wd) & (p2 >= 0.0) & (p2 <= L - 1.0)


def _row_taps(vk, p1, p2, valid, Wd: int, L: int):
    """For window rows z0 = floor(p1) and z0 + 1: (in range, p1 - z, lo,
    hi), and the lane fraction. ``vk`` is plane k flattened (Wd * L,)."""
    f = p1.dtype
    p1 = torch.where(valid, p1, torch.zeros_like(p1))
    p2 = torch.where(valid, p2, torch.zeros_like(p2))
    idx = torch.clamp(p2.to(torch.int64), 0, max(L - 2, 0))  # truncation
    hi_idx = torch.clamp(idx + 1, max=L - 1)
    fx = torch.clamp(p2 - idx.to(f), 0.0, 1.0)
    z0 = torch.floor(p1)
    taps = []
    for dz in (0, 1):
        z = z0 + dz
        inb = valid & (z >= 0) & (z < Wd)
        zi = torch.clamp(z.to(torch.int64), 0, Wd - 1) * L
        taps.append((inb, p1 - z, vk[zi + idx], vk[zi + hi_idx]))
    return taps, fx


def _slab_sample(fields, k, inv_d0, half, abs_d0, a_in, a_out, Wd, L):
    alpha, p1, p2 = _positions(fields, k, inv_d0)
    w_alpha = torch.clamp(
        torch.minimum(alpha + half, a_out) - torch.maximum(alpha - half, a_in), min=0.0
    ) * abs_d0
    valid = (w_alpha > 0.0) & _inside(p1, p2, Wd, L) & (fields[6] > 0.0)
    return p1, p2, w_alpha, valid


def _two_row_sum(taps, fx, w_alpha, acc):
    for inb, diff, lo, hi in taps:
        wz = torch.clamp(1.0 - torch.abs(diff), min=0.0)
        v = lo + fx * (hi - lo)
        acc = acc + torch.where(inb, wz * w_alpha, torch.zeros_like(wz)) * v
    return acc


def _slab_forward(vol, fields) -> torch.Tensor:
    """Plain version of K5: ``vol`` (M, Wd, L) bf16, ``fields`` (7, B, R)
    -> (B, R) in ``fields``' dtype."""
    M, Wd, L = vol.shape
    _, inv_d0, abs_d0 = _march(fields)
    half = 0.5 * torch.abs(inv_d0)
    a_in, a_out = _box(fields, (M, Wd, L))
    vf = vol.to(fields.dtype).reshape(M, Wd * L)
    acc = torch.zeros_like(fields[0])
    for k in range(M):
        p1, p2, w_alpha, valid = _slab_sample(fields, k, inv_d0, half, abs_d0, a_in, a_out, Wd, L)
        taps, fx = _row_taps(vf[k], p1, p2, valid, Wd, L)
        acc = _two_row_sum(taps, fx, w_alpha, acc)
    return acc * fields[6]


def _slab_channels(vol, labels, chans, fields) -> torch.Tensor:
    """Plain version of K7: ``labels`` (M, Wd, L) uint8, ``chans`` label
    values -> (B, 1 + len(chans), R). Each plane's two-row sum goes to the
    channel(s) of the nearest voxel's label (round half to even)."""
    M, Wd, L = vol.shape
    _, inv_d0, abs_d0 = _march(fields)
    half = 0.5 * torch.abs(inv_d0)
    a_in, a_out = _box(fields, (M, Wd, L))
    vf = vol.to(fields.dtype).reshape(M, Wd * L)
    lf = labels.reshape(M, Wd * L)
    chans = [int(c) for c in chans]
    accs = [torch.zeros_like(fields[0]) for _ in range(len(chans) + 1)]
    for k in range(M):
        p1, p2, w_alpha, valid = _slab_sample(fields, k, inv_d0, half, abs_d0, a_in, a_out, Wd, L)
        taps, fx = _row_taps(vf[k], p1, p2, valid, Wd, L)
        contrib = _two_row_sum(taps, fx, w_alpha, torch.zeros_like(accs[0]))
        rn = torch.clamp(torch.round(torch.where(valid, p1, torch.zeros_like(p1))), 0, Wd - 1)
        ln = torch.clamp(torch.round(torch.where(valid, p2, torch.zeros_like(p2))), 0, L - 1)
        lab = lf[k][rn.to(torch.int64) * L + ln.to(torch.int64)].to(torch.int64)
        lab = torch.where(valid, lab, torch.zeros_like(lab))
        fg = torch.zeros_like(valid)
        for j, c in enumerate(chans):
            match = lab == c
            fg = fg | match
            accs[j + 1] = accs[j + 1] + torch.where(match, contrib, torch.zeros_like(contrib))
        accs[0] = accs[0] + torch.where(fg, torch.zeros_like(contrib), contrib)
    return torch.stack(accs, dim=1) * fields[6][:, None]


def _box_with_partials(fields, shape):
    """a_in, a_out and their partials (lists of 6, order s0 s1 s2 d0 d1 d2)
    through the active axis and side."""
    zero = torch.zeros_like(fields[0])
    a_in, a_out = zero.clone(), torch.ones_like(zero)
    dain, daout = [zero] * 6, [zero] * 6
    for i, n in enumerate(shape):
        s, d = fields[i], fields[3 + i]
        parallel = torch.abs(d) < 1e-9
        safe = torch.where(parallel, _full(d, 1e-9), d)
        t1 = (-0.5 - s) / safe
        t2 = ((n - 0.5) - s) / safe
        use1 = t1 <= t2
        lo, hi = torch.where(use1, t1, t2), torch.where(use1, t2, t1)
        inv = 1.0 / safe
        ds = torch.where(parallel, zero, -inv)  # d lo/d s = d hi/d s
        dld = torch.where(parallel, zero, -lo * inv)
        dhd = torch.where(parallel, zero, -hi * inv)
        inside = (s > -0.5) & (s < n - 0.5)
        lo = torch.where(parallel, torch.where(inside, _full(lo, -BIG), _full(lo, BIG)), lo)
        hi = torch.where(parallel, torch.where(inside, _full(hi, BIG), _full(hi, -BIG)), hi)
        take_lo = lo > a_in
        a_in = torch.maximum(a_in, lo)
        dain = [torch.where(take_lo, zero, g) for g in dain]
        dain[i] = torch.where(take_lo, ds, dain[i])
        dain[3 + i] = torch.where(take_lo, dld, dain[3 + i])
        take_hi = hi < a_out
        a_out = torch.minimum(a_out, hi)
        daout = [torch.where(take_hi, zero, g) for g in daout]
        daout[i] = torch.where(take_hi, ds, daout[i])
        daout[3 + i] = torch.where(take_hi, dhd, daout[3 + i])
    clip_out = a_out < a_in
    a_out = torch.maximum(a_out, a_in)
    daout = [torch.where(clip_out, gi, go) for gi, go in zip(dain, daout)]
    return a_in, a_out, dain, daout


def _slab_backward(vol, fields, g) -> torch.Tensor:
    """Plain version of K6: the gradient of <g, K5(fields)> with respect to
    the fields -> (7, B, R) in ``fields``' dtype."""
    M, Wd, L = vol.shape
    f = fields.dtype
    s0, s1, s2, d0, d1, d2, ws = fields
    safe_d0, inv_d0, abs_d0 = _march(fields)
    sgn_d0 = torch.sign(safe_d0)
    half = 0.5 / abs_d0
    dh_dd0 = -sgn_d0 * 2.0 * half * half  # d(1/(2|d0|))/d d0
    a_in, a_out, dain, daout = _box_with_partials(fields, (M, Wd, L))
    vf = vol.to(f).reshape(M, Wd * L)
    zero = torch.zeros_like(s0)
    gc = g.to(f) * ws
    da_ds0 = -inv_d0
    sums = [zero] * 7
    for k in range(M):
        alpha, p1, p2 = _positions(fields, k, inv_d0)
        da_dd0 = -alpha * inv_d0
        u_arg, v_arg = alpha + half, alpha - half
        u, v = torch.minimum(u_arg, a_out), torch.maximum(v_arg, a_in)
        span = torch.clamp(u - v, min=0.0)
        W = span * abs_d0
        open_ = span > 0.0
        u_int, v_int = u_arg < a_out, v_arg > a_in
        valid = open_ & _inside(p1, p2, Wd, L) & (ws > 0.0)
        taps, fx = _row_taps(vf[k], p1, p2, valid, Wd, L)
        Bs, dB1, dB2 = zero, zero, zero
        for inb, diff, lo, hi in taps:
            row = (inb & (torch.abs(diff) < 1.0)).to(f)
            wz = torch.clamp(1.0 - torch.abs(diff), min=0.0)
            val = lo + fx * (hi - lo)
            Bs = Bs + row * wz * val
            dB1 = dB1 + row * -torch.sign(diff) * val
            dB2 = dB2 + row * wz * (hi - lo)

        def dspan(d_alpha, d_h, d_ain, d_aout):
            du = torch.where(u_int, d_alpha + d_h, d_aout)
            dv = torch.where(v_int, d_alpha - d_h, d_ain)
            return torch.where(open_, du - dv, zero)

        gcv = gc * valid.to(f)
        terms = [
            (abs_d0 * dspan(da_ds0, zero, dain[0], daout[0]),
             W * (dB1 * d1 * da_ds0 + dB2 * d2 * da_ds0)),
            (abs_d0 * dspan(zero, zero, dain[1], daout[1]), W * dB1),
            (abs_d0 * dspan(zero, zero, dain[2], daout[2]), W * dB2),
            (abs_d0 * dspan(da_dd0, dh_dd0, dain[3], daout[3]) + span * sgn_d0,
             W * (dB1 * d1 * da_dd0 + dB2 * d2 * da_dd0)),
            (abs_d0 * dspan(zero, zero, dain[4], daout[4]), W * dB1 * alpha),
            (abs_d0 * dspan(zero, zero, dain[5], daout[5]), W * dB2 * alpha),
        ]
        for j, (dW, rest) in enumerate(terms):
            sums[j] = sums[j] + gcv * (dW * Bs + rest)
        sums[6] = sums[6] + torch.where(valid, W * Bs, zero)
    sums[6] = g.to(f) * sums[6]
    return torch.stack(sums)


def _slab_siddon(vol, fields) -> torch.Tensor:
    """Plain version of K8: the exact Siddon forward -> (B, R)."""
    M, Wd, L = vol.shape
    f = fields.dtype
    s0, s1, s2, d0, d1, d2, ws = fields
    _, inv_d0, abs_d0 = _march(fields)
    half = 0.5 * torch.abs(inv_d0)
    safe_d1 = torch.where(torch.abs(d1) < 1e-9, _full(d1, 1e-9), d1)
    safe_d2 = torch.where(torch.abs(d2) < 1e-9, _full(d2, 1e-9), d2)
    a_in, a_out = _box(fields, (M, Wd, L))
    vf = vol.to(f).reshape(M, Wd * L)
    acc = torch.zeros_like(s0)
    big = _full(s0, BIG)

    def index(p, n):
        return torch.clamp(torch.round(p), 0, n - 1).to(torch.int64)

    for k in range(M):
        alpha = (float(k) - s0) * inv_d0
        aa = torch.maximum(alpha - half, a_in)
        ab = torch.minimum(alpha + half, a_out)
        seg = ab - aa
        valid = (seg > 0.0) & (ws > 0.0)
        aa = torch.where(valid, aa, torch.zeros_like(aa))
        ab = torch.where(valid, ab, torch.zeros_like(ab))
        eps = 1e-5 * torch.clamp(seg, min=0.0)
        ra, rb = index(s1 + (aa + eps) * d1, Wd), index(s1 + (ab - eps) * d1, Wd)
        ca, cb = index(s2 + (aa + eps) * d2, L), index(s2 + (ab - eps) * d2, L)
        tw = torch.where(ra != rb, ((torch.maximum(ra, rb).to(f) - 0.5) - s1) / safe_d1, big)
        tl = torch.where(ca != cb, ((torch.maximum(ca, cb).to(f) - 0.5) - s2) / safe_d2, big)
        first_is_w = tw <= tl
        t1c = torch.clamp(torch.minimum(tw, tl), min=aa, max=ab)
        t2c = torch.clamp(torch.maximum(tw, tl), min=aa, max=ab)
        L1, L2, L3 = t1c - aa, t2c - t1c, ab - t2c
        zero = torch.zeros_like(L2)
        L_rb_ca = torch.where(first_is_w, L2, zero)
        L_ra_cb = torch.where(first_is_w, zero, L2)
        cmin = torch.clamp(torch.minimum(ca, cb), 0, L - 1)
        chi = torch.clamp(cmin + 1, max=L - 1)
        lo_a, hi_a = vf[k][ra * L + cmin], vf[k][ra * L + chi]
        lo_b, hi_b = vf[k][rb * L + cmin], vf[k][rb * L + chi]
        a_ca, a_cb = torch.where(ca == cmin, lo_a, hi_a), torch.where(cb == cmin, lo_a, hi_a)
        b_ca, b_cb = torch.where(ca == cmin, lo_b, hi_b), torch.where(cb == cmin, lo_b, hi_b)
        contrib = (L1 * a_ca + L_ra_cb * a_cb) + (L_rb_ca * b_ca + L3 * b_cb)
        acc = acc + torch.where(valid, contrib, zero)
    return acc * ws * abs_d0


# ---------------------------------------------------------------------------
# Dispatch: the kernel on a CUDA tensor, the plain version on a CPU tensor
# ---------------------------------------------------------------------------


def slab_forward(vol, fields) -> torch.Tensor:
    """K5 on CUDA tensors, :func:`_slab_forward` on CPU tensors."""
    if _device_kind(vol) == "cpu":
        return _slab_forward(vol, fields)
    return _cuda.slab_forward(vol, fields.contiguous())


def slab_backward(vol, fields, g) -> torch.Tensor:
    """K6 on CUDA tensors, :func:`_slab_backward` on CPU tensors."""
    if _device_kind(vol) == "cpu":
        return _slab_backward(vol, fields, g)
    return _cuda.slab_backward(vol, fields.contiguous(), g.contiguous())


def slab_channels(vol, labels, chans, fields) -> torch.Tensor:
    """K7 on CUDA tensors, :func:`_slab_channels` on CPU tensors."""
    if _device_kind(vol) == "cpu":
        return _slab_channels(vol, labels, chans, fields)
    return _cuda.slab_channels(vol, labels, chans, fields.contiguous())


def slab_siddon(vol, fields) -> torch.Tensor:
    """K8 on CUDA tensors, :func:`_slab_siddon` on CPU tensors."""
    if _device_kind(vol) == "cpu":
        return _slab_siddon(vol, fields)
    return _cuda.slab_siddon(vol, fields.contiguous())


class _SlabCore(torch.autograd.Function):
    """K5 forward, K6 backward; the volume gets no gradient (the CT is data)."""

    @staticmethod
    def forward(ctx, vol, fields):
        ctx.save_for_backward(vol, fields)
        return slab_forward(vol, fields)

    @staticmethod
    def backward(ctx, g):
        vol, fields = ctx.saved_tensors
        return None, slab_backward(vol, fields, g)


class _SlabChannels(torch.autograd.Function):
    """K7 forward; backward is K6 on the mean over channels of the
    cotangent. That is exact when the channels are consumed through their
    sum (and non-differentiable indicators), as the training loss does;
    per-channel attribution is not modelled, as in the JAX package."""

    @staticmethod
    def forward(ctx, vol, labels, chans, fields):
        ctx.save_for_backward(vol, fields)
        return slab_channels(vol, labels, chans, fields)

    @staticmethod
    def backward(ctx, g):
        vol, fields = ctx.saved_tensors
        return None, None, None, slab_backward(vol, fields, g.mean(dim=1))


class _SiddonForward(torch.autograd.Function):
    """K8, forward only: asking it for a gradient raises."""

    @staticmethod
    def forward(ctx, vol, fields):
        return slab_siddon(vol, fields)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError(
            "raymarch_siddon_pallas is forward only; differentiate xla.raymarch_siddon instead"
        )


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _prepare(density, affine_inverse, source, target, det_shape, perm, packed):
    """Shared argument handling -> (table, fields, perm)."""
    R = target.shape[1]
    if det_shape is None and int(round(np.sqrt(R))) ** 2 != R:
        raise ValueError("det_shape required for non-square ray grids")
    if perm is None:
        # the dominant mean ray direction in voxel space (host probe)
        A = affine_inverse.detach()[:3, :3]
        d_mean = ((target - source.expand(target.shape)).detach() @ A.T).mean(dim=(0, 1))
        perm = _choose_permutation(d_mean.cpu().double().numpy())
    perm = tuple(int(p) for p in perm)
    vol = pack_density(density, perm)[0] if packed is None else packed[0]
    s_p, d_p, wscale = _decompose(affine_inverse, source, target, perm)
    return vol, _fields(s_p, d_p, wscale), perm


def raymarch_trilinear_pallas(
    density: torch.Tensor,
    affine_inverse: torch.Tensor,
    source: torch.Tensor,
    target: torch.Tensor,
    n_samples: int | None = None,
    mask=None,
    labels=None,
    det_shape: tuple[int, int] | None = None,
    window: int = 32,
    interpret: bool | None = None,
    perm: tuple[int, int, int] | None = None,
    packed=None,
    remap: bool = False,
    stream: bool | None = None,
) -> torch.Tensor:
    """Drop-in for :func:`xvr_tpu_torch.render.xla.raymarch_trilinear` through
    the slab kernels: ``source`` (B, 1|R, 3), ``target`` (B, R, 3) world mm
    -> (B, R), or (B, C, R) with ``mask`` and ``labels`` (K7, channel 0 =
    labels outside the list). Differentiable with respect to ``source`` and
    ``target`` (K6). ``packed`` is ``pack_density``'s result for ``perm``;
    ``n_samples``, ``window``, ``interpret``, ``remap`` and ``stream`` are
    accepted for signature parity and ignored."""
    vol, fields, perm = _prepare(density, affine_inverse, source, target, det_shape, perm, packed)
    if mask is not None and labels is not None:
        lab = pack_labels(mask, perm)
        return _SlabChannels.apply(vol, lab, tuple(int(x) for x in labels), fields)
    return _SlabCore.apply(vol, fields)


def raymarch_siddon_pallas(
    density: torch.Tensor,
    affine_inverse: torch.Tensor,
    source: torch.Tensor,
    target: torch.Tensor,
    mask=None,
    labels=None,
    det_shape: tuple[int, int] | None = None,
    window: int = 32,
    interpret: bool | None = None,
    perm: tuple[int, int, int] | None = None,
    packed=None,
    remap: bool = False,
    stream: bool | None = None,
) -> torch.Tensor:
    """Exact Siddon forward through K8, the golden cross-check: exact within
    the bf16 volume quantization while rays stay within ~45 degrees of the
    march axis. Forward only (asking for a gradient raises). With ``mask``
    and ``labels`` it renders through the golden
    :func:`~xvr_tpu_torch.render.xla.raymarch_siddon`, as the JAX package
    does. ``window``, ``interpret``, ``remap`` and ``stream`` are ignored."""
    if mask is not None and labels is not None:
        return xla.raymarch_siddon(density, affine_inverse, source, target, mask=mask,
                                   labels=labels)
    vol, fields, _ = _prepare(density, affine_inverse, source, target, det_shape, perm, packed)
    return _SiddonForward.apply(vol, fields)
