"""A float64 model of the plan of the slab kernels K5-K8 (csrc/slab.cu).

The kernels trim each ray's planes to those whose slab can meet its box,
split them into P contiguous parts (P warps share 32 rays) that are summed in
part order, and march an interval of lean planes (slab inside the box, both
rows and both lanes of the taps inside the volume) without tests, clamps or
masks: the interval is estimated, then checked at its two ends. K6 factors
its per-ray constants out of the plane sums and adds box-plane terms only on
the planes that hold a box end. K7 takes K5's plan with K6's op-by-op
positions and adds each plane to the channels of its nearest label through
a label-byte -> channel-mask table; K8's lean planes take their four
rounded indices unclamped. The model takes those steps in float64 and
must equal the plain versions (render/pallas.py, held against the JAX
package in test_torch_pallas.py) to 1e-10, so the plan neither drops nor
double-counts a plane. On the float32 rays the kernels see, it also checks
that the trimmed range holds every plane the plain version marks valid, and
that the lean planes of a ray form one interval (which makes checking its
two ends enough). Geometry comes from chip_smoke.py's K5/K6 edge cases at a
smaller batch.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from xvr_tpu_torch.render import pallas as tpallas
from torch_threads import two_torch_threads  # noqa: F401

# the kernels' constants (top of csrc/slab.cu)
THREADS = 256
SPLIT_MAX = 8
SPLIT_TARGET_WARPS = 8448


def plane_split(B: int, R: int) -> int:
    """Warps that share one ray's planes: doubled while the grid holds fewer
    than SPLIT_TARGET_WARPS warps, at most SPLIT_MAX (slab.cu plane_split)."""
    warps = B * ((R + 31) // 32)
    p = 1
    while p < SPLIT_MAX and warps * p < SPLIT_TARGET_WARPS:
        p *= 2
    return p


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (test id, chip_smoke.SLAB_EDGE_CASES label, B, R)
CASES = [
    ("steep", "steep", 2, 200),
    ("parallel", "parallel", 2, 200),
    ("source_inside", "source inside", 2, 200),
    ("odd_sizes", "odd sizes", 2, 300),
    ("trainer_volume", "trainer batch", 2, 150),
]
IDS = [c[0] for c in CASES]


def _inputs(label, B, R, dtype=torch.float64):
    vol, fields = _smoke().slab_edge_inputs(label, device="cpu", B=B, R=R)
    return vol, fields.to(dtype)


def _fma(a, b, c):
    """a b + c rounded once to the inputs' dtype (float32: as __fmaf_rn)."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def _plan(fields, shape, split):
    """The kernels' per-ray plan: box ends in plane units, the trimmed range
    [lo, hi] and the split parts [(kb, ke)], in the fields' dtype."""
    M = shape[0]
    s0, d0, ws = fields[0], fields[3], fields[6]
    safe = torch.where(d0.abs() < 1e-6, torch.full_like(d0, 1e-6), d0)
    a_in, a_out = tpallas._box(fields, shape)
    e1, e2 = _fma(a_in, safe, s0), _fma(a_out, safe, s0)
    k_lo, k_hi = torch.minimum(e1, e2), torch.maximum(e1, e2)
    box = (a_out > a_in) & (ws > 0)
    lo_f = torch.clamp(torch.nan_to_num(torch.floor(k_lo - 0.5)), 0, M - 1)
    hi_f = torch.clamp(torch.nan_to_num(torch.ceil(k_hi + 0.5)), 0, M - 1)
    lo = torch.where(box, lo_f, 0).long()
    hi = torch.where(box, hi_f, -1).long()
    chunk = (torch.clamp(hi - lo + 1, min=0) + split - 1) // split
    parts = []
    for p in range(split):
        kb = torch.minimum(lo + p * chunk, hi + 1)
        parts.append((kb, torch.minimum(kb + chunk, hi + 1)))
    return dict(safe=safe, inv=1.0 / safe, a_in=a_in, a_out=a_out, k_lo=k_lo, k_hi=k_hi, box=box,
                lo=lo, hi=hi, parts=parts)


def _positions(fields, pl, k, fused=False):
    """alpha, p1, p2, alpha +- half at plane(s) k, op by op (K6), or with
    fused positions (K5)."""
    s0, s1, s2, _, d1, d2, _ = fields
    kf = torch.as_tensor(k, dtype=fields.dtype).expand(s0.shape)
    alpha = (kf - s0) * pl["inv"]
    half = 0.5 / pl["safe"].abs()
    if fused:
        return alpha, _fma(alpha, d1, s1), _fma(alpha, d2, s2), alpha + half, alpha - half
    return alpha, s1 + alpha * d1, s2 + alpha * d2, alpha + half, alpha - half


def _lean_k5(fields, pl, shape, k):
    """K5's lean test at plane(s) k: the slab inside the box (weight 1),
    0 <= p1 < Wd - 1, 0 <= p2 < L - 1."""
    _, Wd, L = shape
    _, p1, p2, u, v = _positions(fields, pl, k, fused=True)
    return (pl["box"] & (u <= pl["a_out"]) & (v >= pl["a_in"]) & (p1 >= 0) & (p1 < Wd - 1)
            & (p2 >= 0) & (p2 < L - 1))


def _lean_k6(fields, pl, shape, k):
    """K6's lean test: u_int, v_int, an open slab, 0 <= p1 < Wd - 1, 0 <= p2 < L - 1."""
    _, Wd, L = shape
    _, p1, p2, u, v = _positions(fields, pl, k)
    return (pl["box"] & (u < pl["a_out"]) & (v > pl["a_in"]) & (u > v) & (p1 >= 0)
            & (p1 < Wd - 1) & (p2 >= 0) & (p2 < L - 1))


def _lean_k7(fields, pl, shape, k):
    """K7's lean test: the slab inside the box and open, 0 <= p1 < Wd - 1,
    0 <= p2 < L - 1, positions op by op (K6's)."""
    _, Wd, L = shape
    _, p1, p2, u, v = _positions(fields, pl, k)
    return (pl["box"] & (u <= pl["a_out"]) & (v >= pl["a_in"]) & (u > v) & (p1 >= 0)
            & (p1 < Wd - 1) & (p2 >= 0) & (p2 < L - 1))


def _siddon_ends(fields, pl, k):
    """K8's slab at plane(s) k without the box: (alpha - half, alpha + half,
    the window and lane positions at both ends moved inward by eps)."""
    s0, s1, s2, _, d1, d2, _ = fields
    alpha, _, _, u, v = _positions(fields, pl, k)
    eps = 1e-5 * (u - v)
    xa, xb = v + eps, u - eps
    return v, u, s1 + xa * d1, s1 + xb * d1, s2 + xa * d2, s2 + xb * d2


def _lean_k8(fields, pl, shape, k):
    """K8's lean test: the slab inside the box and open, its end positions in
    [0, Wd - 1] and [0, L - 1.5) (rounded indices in range, a second lane)."""
    _, Wd, L = shape
    v, u, p1a, p1b, p2a, p2b = _siddon_ends(fields, pl, k)
    inside = (pl["box"] & (u <= pl["a_out"]) & (v >= pl["a_in"]) & (u > v))
    for p in (p1a, p1b):
        inside = inside & (p >= 0) & (p <= Wd - 1)
    for p in (p2a, p2b):
        inside = inside & (p >= 0) & (p < L - 1.5)
    return inside


def _lean_part(fields, pl, shape, kb, ke, lean, slab_ends=False):
    """The kernels' lean interval [ia, ib) of part [kb, ke): the estimate
    (box interior, window and lane crossings, one plane to spare on each
    side), kept only if both of its ends pass ``lean``; else empty [ke, ke).
    With ``slab_ends`` (K8) the estimate keeps the positions at both ends of
    the slab, |m| / 2 from its centre, in [0, Wd - 1] and [0, L - 1.5]."""
    _, Wd, L = shape
    f = fields.dtype
    ka, kz = pl["k_lo"] + 1.5, pl["k_hi"] - 1.5
    for axis, top in ((1, Wd - 1), (2, L - 1.5 if slab_ends else L - 1)):
        m = fields[3 + axis] * pl["inv"]
        c = fields[axis] - fields[0] * m
        h = 0.5 * m.abs() if slab_ends else 0.0
        t1, t2 = (h - c) / m, (top - h - c) / m
        ka = torch.fmax(ka, torch.fmin(t1, t2) + 1.0)
        kz = torch.fmin(kz, torch.fmax(t1, t2) - 1.0)
    ka, kz = torch.fmax(ka, kb.to(f)), torch.fmin(kz, (ke - 1).to(f))
    ok = (ka <= kz) & (torch.ceil(ka) <= torch.floor(kz))
    ia = torch.where(ok, torch.ceil(ka), ke.to(f)).long()
    ib = torch.where(ok, torch.floor(kz) + 1, ke.to(f)).long()
    keep = (ia < ib) & lean(fields, pl, shape, ia) & lean(fields, pl, shape, ib - 1)
    return torch.where(keep, ia, ke), torch.where(keep, ib, ke)


def _taps(vol, k, q1, q2, shape, clamp_rows):
    """(z0, lo0, hi0, lo1, hi1, fx) of plane k at (q1, q2): rows clamped to
    the volume (the full plane), or to z0 in [0, Wd - 2] (a lean plane)."""
    _, Wd, L = shape
    V = vol[k].to(q1.dtype).reshape(-1)
    idx = torch.clamp(torch.floor(q2), max=max(L - 2, 0)).long()
    z0 = torch.floor(q1).long()
    r0, r1 = (torch.clamp(z0, 0, Wd - 1), torch.clamp(z0 + 1, 0, Wd - 1)) if clamp_rows else (
        torch.clamp(z0, 0, Wd - 2), torch.clamp(z0 + 1, 1, Wd - 1))
    step = 1 if L > 1 else 0
    lo0, hi0 = V[r0 * L + idx], V[r0 * L + idx + step]
    lo1, hi1 = V[r1 * L + idx], V[r1 * L + idx + step]
    return z0, lo0, hi0, lo1, hi1, q2 - idx.to(q2.dtype)


def _model_forward(vol, fields, split):
    """K5's plan in float64 -> ((B, R), stats)."""
    shape = tuple(vol.shape)
    M, Wd, L = shape
    pl = _plan(fields, shape, split)
    abs_d0 = pl["safe"].abs()
    zero = torch.zeros_like(fields[0])
    sums, stats = [], dict(lean=0, full=0)
    for kb, ke in pl["parts"]:
        ia, ib = _lean_part(fields, pl, shape, kb, ke, _lean_k5)
        acc = zero
        for k in range(M):
            lean = (k >= ia) & (k < ib)
            full = (k >= kb) & (k < ke) & ~lean
            _, p1, p2, u, v = _positions(fields, pl, k, fused=True)
            w = torch.clamp(torch.minimum(u, pl["a_out"]) - torch.maximum(v, pl["a_in"]),
                            min=0.0) * abs_d0
            valid = (w > 0) & (p1 > -1) & (p1 < Wd) & (p2 >= 0) & (p2 <= L - 1)
            # the full plane: positions 0 where invalid, clamped rows, masks
            q1, q2 = torch.where(valid, p1, zero), torch.where(valid, p2, zero)
            z0, lo0, hi0, lo1, hi1, fx = _taps(vol, k, q1, q2, shape, clamp_rows=True)
            fy = q1 - z0.to(q1.dtype)
            v0 = torch.where(z0 >= 0, lo0 + fx * (hi0 - lo0), zero)
            v1 = torch.where(z0 + 1 < Wd, lo1 + fx * (hi1 - lo1), zero)
            c_full = torch.where(valid, w, zero) * (v0 + fy * (v1 - v0))
            # the lean plane: weight 1, no mask (read where lean only)
            q1, q2 = torch.where(lean, p1, zero), torch.where(lean, p2, zero)
            z0, lo0, hi0, lo1, hi1, fx = _taps(vol, k, q1, q2, shape, clamp_rows=False)
            fy = q1 - z0.to(q1.dtype)
            v0, v1 = lo0 + fx * (hi0 - lo0), lo1 + fx * (hi1 - lo1)
            c_lean = v0 + fy * (v1 - v0)
            if bool(lean.any()):
                np.testing.assert_allclose(c_lean[lean], c_full[lean], rtol=1e-12, atol=1e-12)
            acc = acc + torch.where(full, c_full, zero) + torch.where(lean, c_lean, zero)
            stats["lean"] += int(lean.sum())
            stats["full"] += int(full.sum())
        sums.append(acc)
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    return total * fields[6], stats


def _dspan(u_int, v_int, d_alpha, d_h, d_ain, d_aout):
    return torch.where(u_int, d_alpha + d_h, d_aout) - torch.where(v_int, d_alpha - d_h, d_ain)


def _model_backward(vol, fields, g, split):
    """K6's plan in float64: factored sums, box-plane terms on box-end
    planes only -> ((7, B, R), stats)."""
    shape = tuple(vol.shape)
    M, Wd, L = shape
    s0, s1, s2, d0, d1, d2, ws = fields
    pl = _plan(fields, shape, split)
    inv, safe = pl["inv"], pl["safe"]
    abs_d0, sgn = safe.abs(), torch.sign(safe)
    half = 0.5 / abs_d0
    dh = -sgn * 2.0 * half * half
    _, _, dain, daout = tpallas._box_with_partials(fields, shape)
    zero = torch.zeros_like(s0)
    gc = g * ws
    parts = []
    stats = dict(lean=0, full=0, box_end=torch.zeros_like(s0, dtype=torch.long))
    for kb, ke in pl["parts"]:
        ia, ib = _lean_part(fields, pl, shape, kb, ke, _lean_k6)
        S = dict(S1=zero, S2=zero, S1a=zero, S2a=zero, S3=zero, S6=zero)
        E = [zero] * 5
        for k in range(M):
            lean = (k >= ia) & (k < ib)
            full = (k >= kb) & (k < ke) & ~lean
            alpha, p1, p2, u_arg, v_arg = _positions(fields, pl, k)
            da_dd0 = -alpha * inv
            dW3_int = abs_d0 * ((da_dd0 + dh) - (da_dd0 - dh))
            # the full plane
            span = torch.clamp(torch.minimum(u_arg, pl["a_out"]) - torch.maximum(v_arg, pl["a_in"]),
                               min=0.0)
            u_int, v_int = u_arg < pl["a_out"], v_arg > pl["a_in"]
            valid = (span > 0) & (p1 > -1) & (p1 < Wd) & (p2 >= 0) & (p2 <= L - 1)
            W = torch.where(valid, span * abs_d0, zero)
            q1, q2 = torch.where(valid, p1, zero), torch.where(valid, p2, zero)
            z0, lo0, hi0, lo1, hi1, fx = _taps(vol, k, q1, q2, shape, clamp_rows=True)
            dd0 = q1 - z0.to(q1.dtype)
            dd1 = q1 - (z0.to(q1.dtype) + 1.0)
            on0, on1 = (z0 >= 0) & (dd0 < 1), (z0 + 1 < Wd) & (dd1 > -1)
            val0, val1 = lo0 + fx * (hi0 - lo0), lo1 + fx * (hi1 - lo1)
            wz0, wz1 = torch.where(on0, 1 - dd0, zero), torch.where(on1, 1 + dd1, zero)
            Bs = wz0 * val0 + wz1 * val1
            dB1 = torch.where(on1, val1, zero) - torch.where(on0 & (dd0 > 0), val0, zero)
            dB2 = wz0 * (hi0 - lo0) + wz1 * (hi1 - lo1)
            box_end = valid & ~(u_int & v_int)
            dW3 = torch.where(box_end, abs_d0 * _dspan(u_int, v_int, da_dd0, dh, dain[3], daout[3]),
                              dW3_int) + span * sgn
            full_terms = dict(W=W, Bs=Bs, dB1=dB1, dB2=dB2, dW3=torch.where(valid, dW3, zero))
            for j, (field, d_alpha) in enumerate(((0, -inv), (1, zero), (2, zero), (4, zero),
                                                  (5, zero))):
                dW = abs_d0 * _dspan(u_int, v_int, d_alpha, zero, dain[field], daout[field])
                E[j] = E[j] + torch.where(full & box_end, dW * Bs, zero)
            stats["box_end"] += (full & box_end).long()
            # the lean plane: interior, both rows and lanes in the volume
            span_l = u_arg - v_arg
            q1, q2 = torch.where(lean, p1, zero), torch.where(lean, p2, zero)
            z0, lo0, hi0, lo1, hi1, fx = _taps(vol, k, q1, q2, shape, clamp_rows=False)
            dd0 = q1 - z0.to(q1.dtype)
            dd1 = q1 - (z0.to(q1.dtype) + 1.0)
            on1 = dd1 > -1
            val0, val1 = lo0 + fx * (hi0 - lo0), lo1 + fx * (hi1 - lo1)
            wz0, wz1 = 1 - dd0, torch.where(on1, 1 + dd1, zero)
            lean_terms = dict(
                W=span_l * abs_d0, Bs=wz0 * val0 + wz1 * val1,
                dB1=torch.where(on1, val1, zero) - torch.where(dd0 > 0, val0, zero),
                dB2=wz0 * (hi0 - lo0) + wz1 * (hi1 - lo1), dW3=dW3_int + span_l * sgn)
            if bool(lean.any()):
                for key in lean_terms:
                    np.testing.assert_allclose(lean_terms[key][lean], full_terms[key][lean],
                                               rtol=1e-12, atol=1e-12)
            for terms, on in ((full_terms, full), (lean_terms, lean)):
                t = {key: torch.where(on, x, zero) for key, x in terms.items()}
                S["S1"] = S["S1"] + t["W"] * t["dB1"]
                S["S2"] = S["S2"] + t["W"] * t["dB2"]
                S["S1a"] = S["S1a"] + t["W"] * t["dB1"] * alpha
                S["S2a"] = S["S2a"] + t["W"] * t["dB2"] * alpha
                S["S6"] = S["S6"] + t["W"] * t["Bs"]
                S["S3"] = S["S3"] + t["dW3"] * t["Bs"]
            stats["lean"] += int(lean.sum())
            stats["full"] += int(full.sum())
        parts.append(torch.stack([
            gc * (E[0] - inv * (d1 * S["S1"] + d2 * S["S2"])),
            gc * (E[1] + S["S1"]),
            gc * (E[2] + S["S2"]),
            gc * (S["S3"] - inv * (d1 * S["S1a"] + d2 * S["S2a"])),
            gc * (E[3] + S["S1a"]),
            gc * (E[4] + S["S2a"]),
            S["S6"],
        ]))
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    total[6] = g * total[6]
    return total, stats


def mask_table(chans) -> list[int]:
    """K7's label byte -> channel bit mask (slab.cu slab_channels_kernel):
    bit 1 + j for every chans[j] equal to the byte, else bit 0."""
    table = []
    for t in range(256):
        m = 0
        for j, c in enumerate(chans):
            if int(c) == t:
                m |= 2 << j
        table.append(m or 1)
    return table


def rint_magic(x: torch.Tensor) -> torch.Tensor:
    """slab.cu rint_exact on float32 ``x``: one add of 1.5 * 2^23 rounded to
    nearest, the integer read from the sum's bits."""
    magic = torch.tensor(12582912.0, dtype=torch.float32)
    t = x + magic
    return t.view(torch.int32) - magic.view(torch.int32)


def _model_channels(vol, labels, chans, fields, split):
    """K7's plan in float64: K5's plan with op-by-op positions, each plane's
    two-row sum added to the channels of its nearest label's mask ->
    ((B, C, R), stats)."""
    shape = tuple(vol.shape)
    M, Wd, L = shape
    pl = _plan(fields, shape, split)
    abs_d0 = pl["safe"].abs()
    zero = torch.zeros_like(fields[0])
    table = torch.tensor(mask_table(chans))
    lf = labels.reshape(M, Wd * L).long()
    C = len(chans) + 1
    parts, stats = [], dict(lean=0, full=0)
    for kb, ke in pl["parts"]:
        ia, ib = _lean_part(fields, pl, shape, kb, ke, _lean_k7)
        acc = [zero] * C
        for k in range(M):
            lean = (k >= ia) & (k < ib)
            full = (k >= kb) & (k < ke) & ~lean
            _, p1, p2, u, v = _positions(fields, pl, k)
            w = torch.clamp(torch.minimum(u, pl["a_out"]) - torch.maximum(v, pl["a_in"]),
                            min=0.0) * abs_d0
            valid = (w > 0) & (p1 > -1) & (p1 < Wd) & (p2 >= 0) & (p2 <= L - 1)
            # the full plane: skipped where invalid, clamped rows and labels
            q1, q2 = torch.where(valid, p1, zero), torch.where(valid, p2, zero)
            z0, lo0, hi0, lo1, hi1, fx = _taps(vol, k, q1, q2, shape, clamp_rows=True)
            fy = q1 - z0.to(q1.dtype)
            v0 = torch.where(z0 >= 0, lo0 + fx * (hi0 - lo0), zero)
            v1 = torch.where(z0 + 1 < Wd, lo1 + fx * (hi1 - lo1), zero)
            c_full = w * (v0 + fy * (v1 - v0))
            rn = torch.clamp(torch.round(q1), 0, Wd - 1).long()
            ln = torch.clamp(torch.round(q2), 0, L - 1).long()
            m_full = table[lf[k][rn * L + ln]]
            # the lean plane: weight 1, no clamp of taps or labels
            q1, q2 = torch.where(lean, p1, zero), torch.where(lean, p2, zero)
            z0, lo0, hi0, lo1, hi1, fx = _taps(vol, k, q1, q2, shape, clamp_rows=False)
            fy = q1 - z0.to(q1.dtype)
            v0, v1 = lo0 + fx * (hi0 - lo0), lo1 + fx * (hi1 - lo1)
            c_lean = v0 + fy * (v1 - v0)
            m_lean = table[lf[k][torch.round(q1).long() * L + torch.round(q2).long()]]
            if bool(lean.any()):
                np.testing.assert_allclose(c_lean[lean], c_full[lean], rtol=1e-12, atol=1e-12)
                assert torch.equal(m_lean[lean], m_full[lean])
            for c in range(C):
                bit = 1 << c
                acc[c] = (acc[c] + torch.where(full & valid & (m_full & bit != 0), c_full, zero)
                          + torch.where(lean & (m_lean & bit != 0), c_lean, zero))
            stats["lean"] += int(lean.sum())
            stats["full"] += int((full & valid).sum())
        parts.append(torch.stack(acc, dim=1))
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total * fields[6][:, None], stats


def _model_siddon(vol, fields, split):
    """K8's plan in float64: trimmed range, split parts, lean planes with
    unclamped indices and no seg > 0 test, crossings by reciprocals ->
    ((B, R), stats)."""
    shape = tuple(vol.shape)
    M, Wd, L = shape
    s0, s1, s2, _, d1, d2, ws = fields
    pl = _plan(fields, shape, split)
    abs_d0 = pl["safe"].abs()
    zero = torch.zeros_like(s0)
    big = torch.full_like(s0, tpallas.BIG)
    inv_d1 = 1.0 / torch.where(d1.abs() < 1e-9, torch.full_like(d1, 1e-9), d1)
    inv_d2 = 1.0 / torch.where(d2.abs() < 1e-9, torch.full_like(d2, 1e-9), d2)
    V = vol.to(fields.dtype).reshape(M, Wd * L)

    def segments(k, aa, ab, ra, rb, ca, cb, chi):
        tw = torch.where(ra != rb, ((torch.maximum(ra, rb).to(s1.dtype) - 0.5) - s1) * inv_d1, big)
        tl = torch.where(ca != cb, ((torch.maximum(ca, cb).to(s2.dtype) - 0.5) - s2) * inv_d2, big)
        first_is_w = tw <= tl
        t1c = torch.minimum(torch.maximum(torch.minimum(tw, tl), aa), ab)
        t2c = torch.minimum(torch.maximum(torch.maximum(tw, tl), aa), ab)
        L1, L2, L3 = t1c - aa, t2c - t1c, ab - t2c
        L_rb_ca, L_ra_cb = torch.where(first_is_w, L2, zero), torch.where(first_is_w, zero, L2)
        cmin = torch.minimum(ca, cb)
        lo_a, hi_a = V[k][ra * L + cmin], V[k][ra * L + chi]
        lo_b, hi_b = V[k][rb * L + cmin], V[k][rb * L + chi]
        a_ca, a_cb = torch.where(ca == cmin, lo_a, hi_a), torch.where(cb == cmin, lo_a, hi_a)
        b_ca, b_cb = torch.where(ca == cmin, lo_b, hi_b), torch.where(cb == cmin, lo_b, hi_b)
        return (L1 * a_ca + L_ra_cb * a_cb) + (L_rb_ca * b_ca + L3 * b_cb)

    total, stats = zero, dict(lean=0, full=0)
    for kb, ke in pl["parts"]:
        ia, ib = _lean_part(fields, pl, shape, kb, ke, _lean_k8, slab_ends=True)
        acc = zero
        for k in range(M):
            lean = (k >= ia) & (k < ib)
            part = (k >= kb) & (k < ke)
            v, u, *_ = _siddon_ends(fields, pl, k)
            # the full plane: the slab trimmed to the box, clamped indices
            aa, ab = torch.maximum(v, pl["a_in"]), torch.minimum(u, pl["a_out"])
            act = part & (ab - aa > 0)
            aa, ab = torch.where(act, aa, zero), torch.where(act, ab, zero)
            eps = 1e-5 * (ab - aa)

            def index(p, n):
                return torch.clamp(torch.round(p), 0, n - 1).long()

            ra, rb = index(s1 + (aa + eps) * d1, Wd), index(s1 + (ab - eps) * d1, Wd)
            ca, cb = index(s2 + (aa + eps) * d2, L), index(s2 + (ab - eps) * d2, L)
            chi = torch.clamp(torch.minimum(ca, cb) + 1, max=L - 1)
            c_full = segments(k, aa, ab, ra, rb, ca, cb, chi)
            # the lean plane: the slab's own ends, indices and chi unclamped
            _, _, p1a, p1b, p2a, p2b = _siddon_ends(fields, pl, k)
            r = [torch.where(lean, torch.round(p), zero).long() for p in (p1a, p1b, p2a, p2b)]
            c_lean = segments(k, torch.where(lean, v, zero), torch.where(lean, u, zero), *r,
                              torch.minimum(r[2], r[3]) + 1)
            if bool(lean.any()):
                assert bool(act[lean].all())
                np.testing.assert_allclose(c_lean[lean], c_full[lean], rtol=1e-12, atol=1e-12)
            acc = acc + torch.where(act & ~lean, c_full, zero) + torch.where(lean, c_lean, zero)
            stats["lean"] += int(lean.sum())
            stats["full"] += int((act & ~lean).sum())
        total = total + acc
    return total * ws * abs_d0, stats


def _close(got, ref):
    for j in range(ref.shape[0]) if ref.dim() == 3 else [None]:
        r = ref if j is None else ref[j]
        x = got if j is None else got[j]
        torch.testing.assert_close(x, r, rtol=1e-10, atol=1e-10 * max(float(r.abs().max()), 1e-300))


@pytest.mark.parametrize("name,label,B,R", CASES, ids=IDS)
def test_forward_plan_matches_plain(name, label, B, R):
    vol, fields = _inputs(label, B, R)
    got, stats = _model_forward(vol, fields, plane_split(B, R))
    ref = tpallas._slab_forward(vol, fields)
    assert float(ref.abs().max()) > 0 and stats["full"] > 0
    assert stats["lean"] > 0 or label == "steep"  # a ray along the planes has no lean plane
    _close(got, ref)


@pytest.mark.parametrize("name,label,B,R", CASES, ids=IDS)
def test_backward_plan_matches_plain(name, label, B, R):
    vol, fields = _inputs(label, B, R)
    g = torch.as_tensor(np.random.default_rng(9).normal(size=(B, R)))
    got, stats = _model_backward(vol, fields, g, plane_split(B, R))
    ref = tpallas._slab_backward(vol, fields, g)
    assert float(ref.abs().max()) > 0 and stats["full"] > 0
    assert stats["lean"] > 0 or label == "steep"
    # a box end lies in at most two planes at each end of a ray
    assert int(stats["box_end"].max()) <= 4
    _close(got, ref)


@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_split_parts_match_plain(split):
    """The sum over P parts, for every split the rule can pick, with M = 19
    and ranges no multiple of P."""
    vol, fields = _inputs("odd sizes", 2, 100)
    g = torch.as_tensor(np.random.default_rng(10).normal(size=(2, 100)))
    _close(_model_forward(vol, fields, split)[0], tpallas._slab_forward(vol, fields))
    _close(_model_backward(vol, fields, g, split)[0], tpallas._slab_backward(vol, fields, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,label,B,R", CASES, ids=IDS)
def test_trimmed_range_keeps_every_valid_plane(name, label, B, R, dtype):
    """No plane the plain version marks valid lies outside [lo, hi], with the
    range computed in the fields' dtype as the kernels compute it."""
    vol, fields = _inputs(label, B, R, dtype)
    shape = tuple(vol.shape)
    M, Wd, L = shape
    pl = _plan(fields, shape, 1)
    _, inv_d0, abs_d0 = tpallas._march(fields)
    a_in, a_out = tpallas._box(fields, shape)
    n_valid = 0
    for k in range(M):
        _, _, _, valid = tpallas._slab_sample(fields, k, inv_d0, 0.5 * inv_d0.abs(), abs_d0, a_in,
                                              a_out, Wd, L)
        assert not bool((valid & ((k < pl["lo"]) | (k > pl["hi"]))).any()), k
        n_valid += int(valid.sum())
    assert n_valid > 0
    trimmed = (pl["lo"] > 0) | (pl["hi"] < M - 1)
    assert bool(trimmed.any())


@pytest.mark.parametrize("name,label,B,R", CASES, ids=IDS)
def test_lean_planes_form_one_interval(name, label, B, R):
    """On float32 rays, the planes where K5's and K6's lean tests hold form
    one interval per ray, and the interval the kernels march lies in it."""
    vol, fields = _inputs(label, B, R, torch.float32)
    shape = tuple(vol.shape)
    M = shape[0]
    pl = _plan(fields, shape, plane_split(B, R))
    ks = torch.arange(M)
    for lean in (_lean_k5, _lean_k6):
        mask = torch.stack([lean(fields, pl, shape, int(k)) for k in ks])  # (M, B, R)
        starts = mask & ~torch.cat([torch.zeros_like(mask[:1]), mask[:-1]])
        assert int(starts.sum(0).max()) <= 1
        for kb, ke in pl["parts"]:
            ia, ib = _lean_part(fields, pl, shape, kb, ke, lean)
            inside = (ks[:, None, None] >= ia) & (ks[:, None, None] < ib)
            assert not bool((inside & ~mask).any())
        if label != "steep":
            assert bool(mask.any())


def test_plane_split_rule():
    """P for the path's shapes and the trainer's batch."""
    assert plane_split(16, 60 * 60) == 8  # the coarse sweep
    assert plane_split(4, 239 * 239) == 2  # the fine stage
    assert plane_split(4, 120 * 120) == 8
    assert plane_split(116, 1000) == 4
    assert plane_split(64, 256 * 256) == 1


# K7's label channels: duplicate values (two channels take the same samples),
# values no voxel holds (0 and 3 go to channel 0) and the byte 255
K7_CHANS = (1, 2, 2, 255)


def _labels(shape, seed=11):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.choice([0, 1, 2, 3, 255], shape), dtype=torch.uint8)


@pytest.mark.parametrize("name,label,B,R", CASES, ids=IDS)
def test_channels_plan_matches_plain(name, label, B, R):
    vol, fields = _inputs(label, B, R)
    labels = _labels(vol.shape)
    got, stats = _model_channels(vol, labels, K7_CHANS, fields, plane_split(B, R))
    ref = tpallas._slab_channels(vol, labels, K7_CHANS, fields)
    assert float(ref.abs().max()) > 0 and stats["full"] > 0
    assert stats["lean"] > 0 or label == "steep"
    _close(got, ref)


@pytest.mark.parametrize("name,label,B,R", CASES, ids=IDS)
def test_siddon_plan_matches_plain(name, label, B, R):
    vol, fields = _inputs(label, B, R)
    got, stats = _model_siddon(vol, fields, plane_split(B, R))
    ref = tpallas._slab_siddon(vol, fields)
    assert float(ref.abs().max()) > 0 and stats["full"] > 0
    assert stats["lean"] > 0 or label == "steep"
    _close(got, ref)


@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_split_parts_match_plain_channels_and_siddon(split):
    """K7's and K8's sums over P parts, for every split the rule can pick."""
    vol, fields = _inputs("odd sizes", 2, 100)
    labels = _labels(vol.shape)
    _close(_model_channels(vol, labels, K7_CHANS, fields, split)[0],
           tpallas._slab_channels(vol, labels, K7_CHANS, fields))
    _close(_model_siddon(vol, fields, split)[0], tpallas._slab_siddon(vol, fields))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,label,B,R", CASES, ids=IDS)
def test_trimmed_range_keeps_every_siddon_plane(name, label, B, R, dtype):
    """No plane with a Siddon segment (seg > 0, ws > 0) lies outside [lo, hi]."""
    vol, fields = _inputs(label, B, R, dtype)
    shape = tuple(vol.shape)
    M = shape[0]
    pl = _plan(fields, shape, 1)
    n_seg = 0
    for k in range(M):
        v, u, *_ = _siddon_ends(fields, pl, k)
        seg = torch.minimum(u, pl["a_out"]) - torch.maximum(v, pl["a_in"])
        live = (seg > 0) & (fields[6] > 0)
        assert not bool((live & ((k < pl["lo"]) | (k > pl["hi"]))).any()), k
        n_seg += int(live.sum())
    assert n_seg > 0


@pytest.mark.parametrize("name,label,B,R", CASES, ids=IDS)
def test_channels_and_siddon_lean_planes_form_one_interval(name, label, B, R):
    """On float32 rays, K7's and K8's lean planes form one interval per ray,
    and the interval the kernels march lies in it."""
    vol, fields = _inputs(label, B, R, torch.float32)
    shape = tuple(vol.shape)
    M = shape[0]
    pl = _plan(fields, shape, plane_split(B, R))
    ks = torch.arange(M)
    for lean, slab_ends in ((_lean_k7, False), (_lean_k8, True)):
        mask = torch.stack([lean(fields, pl, shape, int(k)) for k in ks])  # (M, B, R)
        starts = mask & ~torch.cat([torch.zeros_like(mask[:1]), mask[:-1]])
        assert int(starts.sum(0).max()) <= 1
        marched = 0
        for kb, ke in pl["parts"]:
            ia, ib = _lean_part(fields, pl, shape, kb, ke, lean, slab_ends)
            inside = (ks[:, None, None] >= ia) & (ks[:, None, None] < ib)
            assert not bool((inside & ~mask).any())
            marched += int(inside.sum())
        assert marched > 0 or label == "steep"


def test_rint_magic_rounds_half_to_even():
    """rint_exact equals torch.round (half to even) on half-integers, their
    float32 neighbours one ulp away, negatives and the extent limit."""
    f32 = torch.float32
    halves = torch.arange(-40.5, 41.0, 1.0, dtype=f32)
    wide = torch.tensor([2.0**22 - 0.5, -(2.0**22) + 0.5, 4194301.5, -4194301.5, 0.0, -0.0],
                        dtype=f32)
    x = torch.cat([halves, wide])
    x = torch.cat([x, torch.nextafter(x, torch.full_like(x, np.inf)),
                   torch.nextafter(x, torch.full_like(x, -np.inf)),
                   torch.as_tensor(np.random.default_rng(12).uniform(-3e6, 3e6, 2000), dtype=f32)])
    assert torch.equal(rint_magic(x), torch.round(x).to(torch.int32))
    assert rint_magic(torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5])).tolist() == [0, 2, 2, 0, -2, -2]


def test_label_mask_table():
    """Duplicates set two bits, a byte no channel names goes to channel 0,
    255 is a label like any other."""
    t = mask_table(K7_CHANS)
    assert t[1] == 0b10 and t[2] == 0b1100 and t[255] == 0b10000
    assert t[0] == t[3] == t[254] == 1
    assert mask_table(()) == [1] * 256
    assert mask_table((255,))[255] == 2 and mask_table((255,))[0] == 1
    assert mask_table(tuple(range(15)))[14] == 1 << 15  # the kernel's 16 channels
    # the table is the plain version's rule: channel 1 + j takes chans[j]
    # (every match), channel 0 takes what nothing matches
    for t_, m in enumerate(mask_table(K7_CHANS)):
        hits = {1 + j for j, c in enumerate(K7_CHANS) if c == t_} or {0}
        assert {c for c in range(len(K7_CHANS) + 1) if m >> c & 1} == hits
