#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the hand-written kernels from ``xvr_tpu_torch/csrc`` (shear-warp K1-K4
and slab march K5-K8), holds each kernel against its plain PyTorch version
at the shapes of the paths that run it, then drives those paths through
their user entry points on the bench scene: a 256^3 CT (384 mm extent,
1.5 mm voxels) and a 1436^2 DICOM X-ray (sdd 1020, 0.194 mm pixels, crop
100). ``xvr_tpu_torch.registrar.RegistrarFixed(...).run(xray)`` registers it
twice with scales 24,12,6, a 16-seed coarse sweep, 4 restart seeds and one
re-anneal, from a ~4 mm initial error: once through shear-warp (K1-K4), once
under XVR_NO_SHEARWARP=1 through the slab kernels (K5, K6). A labelmap render
through ``Projector(labels=...)`` runs K7 (and K6 for its gradient) and a
``siddon_pallas`` render of the ground-truth pose runs K8.

Phases (each prints one or more lines; any failure exits non-zero):

1. device    card name and power limit (nvidia-smi)
2. build     nvcc seconds and the -Xptxas -v report of all eight kernels
3. kernels   K1-K8 against their plain versions at each shape the
             registration renders (B=16 at 60^2, B=4 at 60^2, 120^2, 239^2):
             max error and tolerance, kernel / plain / library times (CUDA
             events) and the bound (K7/K8 also under their full-plane
             operation count), and K2/K3's launch plan; K1-K8 also on steep
             and edge geometry beyond the path's inputs (K2/K3: odd R, a
             misaligned view, samples on the validity bounds, Iv = 2; K7
             with a channel list that holds label 255), and eleven calls of
             each bit-identical; K6 also against a finite difference of K5;
             K7 and K8 at the trainer's shape (B=116 poses at 128^2), checked
             on 8 images and timed on all; then each kernel's device time
             from torch.profiler at every shape, and that of grid_sample,
             K2/K3's library yardstick, beside K2's and K3's each profiled
             alone as grid_sample is
4. slices    GT render; the shear-warp and slab registrations, each with the
             launch counts of its own run and its mTRE; the label and Siddon
             renders, each with its launch counts (and pack_labels' time per
             label render beside K7's); each kernel's device time above its
             bound per registration, stage by stage

The line before the last is one JSON object with a record per kernel; the
last line is ``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from functools import partial
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
SW_SOURCE = "xvr_tpu_torch/csrc/shearwarp.cu"
SLAB_SOURCE = "xvr_tpu_torch/csrc/slab.cu"
REPLACES = {
    "sw_accumulate": "xvr_tpu/render/shearwarp.py:222",
    "sw_warp": "xvr_tpu/render/shearwarp.py:368",
    "sw_warp_grads": "xvr_tpu/render/shearwarp.py:400",
    "sw_accumulate_adjoint": "xvr_tpu/render/shearwarp.py:955",
    "slab_forward": "xvr_tpu/render/pallas.py:92",
    "slab_backward": "xvr_tpu/render/pallas.py:485",
    "slab_channels": "xvr_tpu/render/pallas.py:324",
    "slab_siddon": "xvr_tpu/render/pallas.py:200",
}
# device kernels each wrapper launches, for the profiler's per-kernel times
DEVICE_KERNELS = {
    "sw_accumulate": ("sw_accumulate_tiled_kernel",),
    "sw_warp": ("sw_warp_kernel",),
    "sw_warp_grads": ("sw_warp_grads_kernel",),
    "sw_accumulate_adjoint": ("sw_adjoint_tiled_kernel", "sw_sum_partials_kernel"),
    "slab_forward": ("slab_forward_kernel",),
    "slab_backward": ("slab_backward_kernel",),
    "slab_channels": ("slab_channels_kernel",),
    "slab_siddon": ("slab_siddon_kernel",),
}
# f32 operations per evaluated (ray, plane) pair, counted from slab.cu:
# arithmetic, min/max, abs, floor and rint, a fused multiply-add as 2;
# compares, selects, conversions and loads not counted. Each kernel counts
# its lean plane, which nearly every pair takes (K7: K5's 21 and two rint;
# K8: slab ends 6, their eps-inward copies 2, positions 8, rints 4, crossings 8, clamps 6, lengths 3,
# sums 8, the plane step 1). SLAB_OPS_FULL_PLANE is the earlier count of
# K7's and K8's full plane, kept to print their bounds on both yardsticks
SLAB_OPS = {"slab_forward": 21, "slab_backward": 53, "slab_channels": 23, "slab_siddon": 46}
SLAB_OPS_FULL_PLANE = {"slab_channels": 40, "slab_siddon": 48}


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call from CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiler_ms(calls: dict, reps: int = 10, tries: int = 3) -> dict:
    """Device time per call of each wrapper in ``calls`` (name -> fn) from
    torch.profiler: the CUDA activity's time of the wrapper's kernels, summed
    by kernel name, over ``reps`` calls. -> name -> ms, or None for every
    name when the profiler records no device time on this machine. A session
    can lose the activity records of the kernels launched first, so each
    session starts with a throwaway kernel, and names whose kernels were not
    each recorded a multiple of ``reps`` times while others were are
    profiled again on their own, up to ``tries`` sessions. Fails when a name
    still misses records (a kernel renamed without DEVICE_KERNELS would
    otherwise report 0 ms)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    totals = dict.fromkeys(calls, 0.0)
    pending = dict(calls)
    for attempt in range(tries):
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
                for fn in pending.values():
                    for _ in range(reps):
                        fn()
                torch.cuda.synchronize()
            events = prof.key_averages()
        except Exception as exc:  # the profiler is a measurement, not a phase of the path
            log(f"  profiler: unavailable ({type(exc).__name__}: {exc})")
            return dict.fromkeys(calls)
        seen = {name: [] for name in pending}  # (device us, records) per kernel name
        for ev in events:
            t = float(getattr(ev, "device_time_total", 0) or getattr(ev, "self_device_time_total", 0))
            for name in pending:
                if any(re.search(rf"\b{k}\b", ev.key) for k in DEVICE_KERNELS[name]):
                    seen[name].append((t, ev.count))
        for name, evs in seen.items():
            if evs and all(t and n and n % reps == 0 for t, n in evs):
                totals[name] = sum(t for t, _ in evs)
        if not any(totals.values()):
            log("  profiler: no device time recorded; keeping the CUDA-event times only")
            return dict.fromkeys(calls)
        pending = {name: fn for name, fn in pending.items() if not totals[name]}
        if not pending:
            return {name: totals[name] / 1e3 / reps for name in calls}
        log(f"  profiler: session {attempt + 1} missed launches of {list(pending)}")
    raise AssertionError(f"profiler: missed launches of {list(pending)} in {tries} sessions while "
                         f"other kernels have some; DEVICE_KERNELS names "
                         f"{[DEVICE_KERNELS[n] for n in pending]}")


def library_device_ms(fn, reps: int = 10):
    """Device time per call of one PyTorch call, profiled alone: the sum over
    every device activity it launches (whatever library kernel it picks:
    F.grid_sample with align_corners=True goes to cuDNN). -> (ms or None,
    kernel names)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, names = 0.0, []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) == DeviceType.CUDA:
            total += float(ev.self_device_time_total)
            names.append(ev.key)
    return (total / 1e3 / reps if total else None), names


# ---------------------------------------------------------------------------
# phantom (the construction of scripts/bench_register.py, in NumPy/SciPy)
# ---------------------------------------------------------------------------


def build_phantom(n: int = 256):
    """-> (hu (n,n,n) f32, affine (4,4), fiducials (60,3) world mm)."""
    import numpy as np
    from scipy.ndimage import gaussian_filter

    sp = 384.0 / n
    c = (n - 1) / 2
    X, Y, Z = np.meshgrid(*([np.arange(n, dtype=np.float32)] * 3), indexing="ij")
    body = ((X - c) / (0.45 * n)) ** 2 + ((Y - c) / (0.30 * n)) ** 2 + ((Z - c) / (0.40 * n)) ** 2
    hu = np.where(body <= 1.0, 40.0, -1000.0).astype(np.float32)
    A = np.array([0.0, 0.35 * n, 0.9 * n], np.float32)
    D = np.array([n, 0.3 * n, -0.8 * n], np.float32)
    tstar = np.clip(((X - A[0]) * D[0] + (Y - A[1]) * D[1] + (Z - A[2]) * D[2]) / (D @ D),
                    0.28, 0.72)
    r2 = (X - A[0] - tstar * D[0]) ** 2 + (Y - A[1] - tstar * D[1]) ** 2 + (Z - A[2] - tstar * D[2]) ** 2
    hu = np.where(r2 <= (0.045 * n) ** 2, 1200.0, hu)
    r2 = (X - 0.62 * n) ** 2 + (Y - 0.45 * n) ** 2 + (Z - 0.6 * n) ** 2
    hu = np.maximum(hu, np.where(r2 <= (0.10 * n) ** 2, 1000.0, hu))
    plate = (np.abs(X - 0.35 * n) < 0.04 * n) & (np.abs(Y - 0.55 * n) < 0.12 * n) & (
        np.abs(Z - 0.35 * n) < 0.12 * n
    )
    hu = np.maximum(hu, np.where(plate, 1400.0, hu))
    hu = gaussian_filter(hu, sigma=2.0 * n / 256).astype(np.float32)
    tex = gaussian_filter(np.random.default_rng(5).normal(0.0, 1.0, hu.shape).astype(np.float32),
                          sigma=1.2 * n / 256)
    tex *= 250.0 / max(tex.std(), 1e-6)
    hu = np.where(hu > 400.0, hu + tex, hu).astype(np.float32)
    aff = np.eye(4, dtype=np.float32) * sp
    aff[3, 3] = 1.0
    aff[:3, 3] = -c * sp
    bone = np.argwhere(hu > 600)
    fids = bone[np.random.default_rng(7).choice(len(bone), 60, replace=False)].astype(np.float64) * sp - c * sp
    return hu, aff, fids


def fiducial_mtre(pose_matrix, gt_matrix, fids) -> float:
    """Mean 3D fiducial error (mm) through the inverse of each pose."""
    import numpy as np

    Mi = np.linalg.inv(np.asarray(pose_matrix, np.float64).reshape(4, 4))
    Gi = np.linalg.inv(np.asarray(gt_matrix, np.float64).reshape(4, 4))
    a = fids @ Gi[:3, :3].T + Gi[:3, 3]
    b = fids @ Mi[:3, :3].T + Mi[:3, 3]
    return float(np.linalg.norm(a - b, axis=-1).mean())


def bench_projector(hu, aff, dev="cuda"):
    """The kernels' scene: the CT with its labelmap (1 = bone above 600 HU,
    2 = the plate above 1300 HU), the registration's 1336^2 crop projector,
    and 16 and 4 poses about the ground truth (+-3 degrees, +-10 mm, seed 3).
    -> (volume, projector, pose16, pose4)."""
    import numpy as np
    import torch
    from xvr_tpu_torch.geometry import convert
    from xvr_tpu_torch.render import Projector, Volume

    mask = np.where(hu > 1300.0, 2, np.where(hu > 600.0, 1, 0)).astype(np.int32)
    vol = Volume(data=torch.as_tensor(hu, device=dev), affine=torch.as_tensor(aff, device=dev),
                 mask=torch.as_tensor(mask, device=dev))
    proj = Projector.from_volume(vol, sdd=1020.0, height=1336, delx=0.194)
    rng = np.random.default_rng(3)

    def poses(n):
        rot = np.deg2rad([182.0, -4.0, 3.0]) + np.deg2rad(rng.uniform(-3, 3, (n, 3)))
        xyz = np.array([6.0, 740.0, -10.0]) + rng.uniform(-10, 10, (n, 3))
        return convert(torch.tensor(rot, dtype=torch.float32, device=dev),
                       torch.tensor(xyz, dtype=torch.float32, device=dev), "euler_angles", "ZXY")

    return vol, proj, poses(16), poses(4)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def path_inputs(proj, pose, seed: int):
    """The kernels' inputs exactly as one fast render of ``pose`` through
    ``proj`` (a pyramid stage's projector) produces them."""
    import torch
    from xvr_tpu_torch.render import shearwarp as sw

    grid = sw.default_grid_shape((proj.detector.height, proj.detector.width))
    src, tgt = proj.rays(pose)
    s_p, d_p, ws = sw._decompose(proj.affine_inverse, src, tgt, proj.pallas_perm)
    _, u0, du, v0, dv, uc, vc = sw._slope_pieces(d_p, *grid)
    sgn = sw._march_sign(d_p)
    gen = torch.Generator(device=ws.device).manual_seed(seed)
    g = torch.randn(ws.shape, generator=gen, device=ws.device)
    return dict(grid=grid, s=s_p[:, 0, :].contiguous(), sgn=sgn, u0=u0, du=du, v0=v0, dv=dv,
                uc=uc.contiguous(), vc=vc.contiguous(), ws=ws.contiguous(), g=g)


def active_samples(vol_shape, x, k0=0, k1=None):
    """(b, i, j, k) samples that K1/K4 evaluate for these inputs: slabs in
    front of the source whose window and lane positions touch the volume."""
    import torch

    M, Wd, L = vol_shape
    k1 = M if k1 is None else k1
    Iu, Iv = x["grid"]
    dev = x["s"].device
    k = torch.arange(k0, k1, device=dev, dtype=torch.float32)
    c = k[None, :] - x["s"][:, 0:1]  # (B, K)
    wk = torch.clamp(x["sgn"][:, None] * c + 0.5, 0.0, 1.0) > 0
    u = x["u0"][:, None] + x["du"][:, None] * torch.arange(Iu, device=dev)
    v = x["v0"][:, None] + x["dv"][:, None] * torch.arange(Iv, device=dev)
    wpos = x["s"][:, 1, None, None] + c[:, :, None] * u[:, None, :]  # (B, K, Iu)
    lpos = x["s"][:, 2, None, None] + c[:, :, None] * v[:, None, :]
    nw = ((wpos > -1) & (wpos < Wd)).sum(-1)
    nl = ((lpos > -1) & (lpos < L)).sum(-1)
    return int((wk * nw * nl).sum())


def check(name, got, ref, label, atol, rtol=0.0):
    """|got - ref| <= atol + rtol |ref| everywhere, and finite; -> max abs error."""
    import torch

    diff = (got - ref).abs()
    err = float(diff.max())
    tol = atol + rtol * ref.abs()
    ok = bool(torch.isfinite(got).all()) and bool((diff <= tol).all())
    share = float((diff / tol.clamp(min=1e-300)).max())
    log(f"  {name} {label}: max_abs_err={err:.3e} tol=atol {atol:.3e} + rtol {rtol:g}*|ref| "
        f"(worst {share:.3f} of it) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {label}: outside tolerance (max abs error {err})")
    return err


REPEATS = 10  # calls of a kernel held bit for bit against its first


def same_bits(name, first, call, label):
    """REPEATS more calls of a kernel on the same inputs give the bits of its
    first call (a race in the staging or the reduction would show here)."""
    import torch

    ok = all(torch.equal(first, call()) for _ in range(REPEATS))
    log(f"  {name} {label}: {REPEATS} more calls bit-identical {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {label}: calls differ")


# K1/K4 geometry beyond the path's inputs: (volume shape or None for the bench
# volume, source s_p mean, (u0, du), (v0, dv), slope grid, exact). Each image
# moves it by a random jitter, or if exact by binary fractions that keep every
# float32 position exact (so the float64 reference of K1 sees the kernel's
# positions where one ulp of a lane position is large, as at 2500 lanes)
EDGE_CASES = {
    # a tile's rows span up to ~130 volume rows per slab and its lanes ~260:
    # many staged chunks per slab, tiles across the volume's edges, ragged grid
    "steep, bench volume": (None, (-40.0, 128.0, 128.0), (-3.0, 0.03), (-1.0, 0.02), (200, 100),
                            False),
    # whole tiles at floor(wpos) = -1 and floor(lpos) = L - 1 of an odd-L
    # volume (plain loads instead of cp.async)
    "edge, odd L": ((64, 40, 77), (-20.0, -0.5, 76.5), (0.0, 0.001), (0.0, 0.001), (40, 100),
                    False),
    # 2500 lanes: boxes past a chunk's 2048 bf16, read by the lane pass from
    # global memory
    "wide volume": ((6, 20, 2500), (-12.0, 10.0, 1250.0), (-0.25, 1 / 64), (-85.0, 2.5), (24, 70),
                    True),
}


# K2/K3 inputs beyond the path's: label -> (B, Iu, Iv, R, misaligned). R is
# odd (at B = 3, B R is no multiple of 2 or 4: the scalar tail of a plan of
# two or four pixels per thread); a misaligned case reads its fields from
# views one float past an aligned buffer (the scalar path)
WARP_EDGE_CASES = {
    "odd R, misaligned view": (3, 20, 33, 1001, True),
    "odd R": (3, 20, 33, 1001, False),
    "Iv = 2": (4, 16, 2, 999, False),
}


def warp_edge_inputs(B, Iu, Iv, R, misaligned=False, device="cuda", seed=6):
    """A slope image (B, Iu, Iv) and fields uc, vc, ws (B, R), float32, from a
    fixed seed. In every image, uc takes -1, 0, Iu - 1 and Iu, each exactly
    and one float32 ulp either side, vc takes 0 and Iv - 1 (both with valid
    uc and ws > 0), and some ws are 0; the other pixels spread over and past
    the valid range. ``misaligned``: each field is a contiguous view that
    starts one float past an aligned buffer."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f32 = np.float32
    I = rng.uniform(-1.0, 1.0, (B, Iu, Iv)).astype(f32)
    uc = rng.uniform(-2.0, Iu + 1.0, (B, R)).astype(f32)
    vc = rng.uniform(-1.0, Iv, (B, R)).astype(f32)
    ws = rng.uniform(-0.2, 2.0, (B, R)).astype(f32)
    edge_u = []
    for x in map(f32, (-1.0, 0.0, Iu - 1.0, Iu)):
        edge_u += [np.nextafter(x, f32(-np.inf)), x, np.nextafter(x, f32(np.inf))]
    n = min(R, len(edge_u))
    uc[:, :n] = edge_u[:n]
    m = min(R - n, 2)
    uc[:, n:n + m] = rng.uniform(0.0, Iu - 1.0, (B, m))
    vc[:, n:n + m] = np.array([0.0, Iv - 1.0], f32)[:m]
    vc[:, :n] = rng.uniform(0.0, Iv - 1.0, (B, n))
    ws[:, :n + m] = rng.uniform(0.5, 2.0, (B, n + m))
    ws[:, n + m:n + m + 4] = 0.0

    def field(a):
        if not misaligned:
            return torch.as_tensor(a, device=device)
        buf = torch.empty(B * R + 1, dtype=torch.float32, device=device)
        buf[1:] = torch.as_tensor(a.reshape(-1), device=device)
        return buf[1:].view(B, R)

    return torch.as_tensor(I, device=device), field(uc), field(vc), field(ws)


def check_warps(I, uc, vc, ws, tag):
    """K2 and K3 against their float64 plain versions (1e-5 max|ref|, and
    1e-5 max|I| for K3's three outputs), with REPEATS more calls of each
    bit-identical. -> (max abs error of K2, of K3)."""
    import torch
    from xvr_tpu_torch.render import shearwarp as sw

    I64, w64 = I.double(), [a.double() for a in (uc, vc, ws)]
    k2 = sw.warp(I, uc, vc, ws)
    r2 = sw._warp_plain(I64, *w64, bf16=False)
    e2 = check("K2 sw_warp", k2.double(), r2, tag, 1e-5 * float(r2.abs().max()))
    k3 = sw.warp_with_grads(I, uc, vc, ws)
    r3 = sw._warp_with_grads_plain(I64, *w64, bf16=False)
    e3 = max(check(f"K3 sw_warp_grads[{o}]", a.double(), b, tag, 1e-5 * float(I64.abs().max()))
             for o, (a, b) in enumerate(zip(k3, r3)))
    same_bits("K2 sw_warp", k2, partial(sw.warp, I, uc, vc, ws), tag)
    same_bits("K3 sw_warp_grads", torch.stack(k3),
              lambda: torch.stack(sw.warp_with_grads(I, uc, vc, ws)), tag)
    return e2, e3


def phase_edge_kernels(bench_vol, seed=6):
    """K1 and K4 on EDGE_CASES, K2 and K3 on WARP_EDGE_CASES, against their
    plain versions with the path's tolerances (see phase_kernels), eleven
    calls bit-identical each. -> max abs error per kernel."""
    import numpy as np
    import torch
    from xvr_tpu_torch.render import _cuda
    from xvr_tpu_torch.render import shearwarp as sw

    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")  # noqa: E731
    errs = {"sw_accumulate": 0.0, "sw_accumulate_adjoint": 0.0}
    B = 3
    for label, (shape, s, (u0, du), (v0, dv), (Iu, Iv), exact) in EDGE_CASES.items():
        vol = bench_vol if shape is None else f(rng.uniform(0.0, 1.0, shape)).to(torch.bfloat16)
        if exact:
            ds = np.arange(B)[:, None] * np.array([0.25, 0.125, 0.125])
            jit = lambda x: f(x * np.array([1.0, 1.25, 0.75]))  # noqa: E731
        else:
            ds = rng.normal(0.0, 0.2, (B, 3))
            jit = lambda x: f(x * (1.0 + rng.uniform(-0.05, 0.05, B)))  # noqa: E731
        args = (f(np.array(s) + ds), f(np.ones(B)), jit(u0), jit(du), jit(v0), jit(dv))
        ibar = torch.randn((B, Iu, Iv), generator=torch.Generator(device="cuda").manual_seed(seed),
                           device="cuda")
        for eps in (1.0, 0.25):
            kw = dict(Iu=Iu, Iv=Iv, eps=eps)
            tag = f"{label} vol {tuple(vol.shape)} grid {Iu}x{Iv} eps {eps}"
            k1 = sw.accumulate(vol, *args, **kw)
            r1 = sw._accumulate(vol, *[a.double() for a in args], bf16=False, **kw)
            errs["sw_accumulate"] = max(errs["sw_accumulate"], check(
                "K1 sw_accumulate", k1.double(), r1, tag, 2e-5 * float(r1.abs().max()), 2e-4))
            same_bits("K1 sw_accumulate", k1, lambda: sw.accumulate(vol, *args, **kw), tag)
            k4 = sw.accumulate_adjoint(vol, *args, ibar, **kw)
            r4 = sw._accumulate_adjoint(vol, *args, ibar, bf16=False, **kw)
            errs["sw_accumulate_adjoint"] = max(errs["sw_accumulate_adjoint"], check(
                "K4 sw_accumulate_adjoint", k4, r4, tag, 1e-4 * float(r4.abs().max()), 1e-3))
            same_bits("K4 sw_accumulate_adjoint", k4,
                      lambda: sw.accumulate_adjoint(vol, *args, ibar, **kw), tag)
    errs.update(sw_warp=0.0, sw_warp_grads=0.0)
    for label, (B, Iu, Iv, R, mis) in WARP_EDGE_CASES.items():
        I, uc, vc, ws = warp_edge_inputs(B, Iu, Iv, R, mis, seed=seed)
        tag = f"{label} B={B} grid {Iu}x{Iv} R={R}"
        e2, e3 = check_warps(I, uc, vc, ws, tag)
        errs["sw_warp"], errs["sw_warp_grads"] = max(errs["sw_warp"], e2), max(errs["sw_warp_grads"], e3)
    _cuda.reset_launches()
    return errs


def stage_cases(projector, pose16, pose4):
    """(label, poses, detector scale) of each shape the registration renders:
    the coarse sweep's 16 poses at the coarse scale, then 4 poses at the
    coarse, middle and fine scales of the passes; coarse first, fine last."""
    from xvr_tpu_torch.registrar.base import _parse_scales

    s_coarse, s_mid, s_fine = _parse_scales("24,12,6", 100, projector.detector.height)
    return [("coarse B=16", pose16, s_coarse), ("coarse B=4", pose4, s_coarse),
            ("mid B=4", pose4, s_mid), ("fine B=4", pose4, s_fine)]


def phase_kernels(projector, pose16, pose4, time_ms=cuda_time_ms):
    """K1-K4 against their plain versions at the path's shapes (those of
    :func:`stage_cases`).

    The reference is the plain version with ``bf16=False``: the kernels' own
    arithmetic (band sums from the bf16 volume). For K1, K2 and K3 it runs in
    float64, so it shows the kernels' f32 rounding. K4 sums hat', which jumps
    at integer positions, so its reference computes the sample positions in
    float32 exactly as the kernel does (one rounding per operation) and sums
    with float32 matrix products. Tolerances (atol relative to max|ref|,
    plus rtol): K1 2e-5 + 2e-4 (all terms positive: f32 accumulation over
    <= 256 slabs), K4 1e-4 + 1e-3 (signed terms that cancel), K2/K3 1e-5.
    Each line also shows the distance to the default plain version, the JAX
    package's bf16 recipe, which the CPU path runs."""
    import torch
    import torch.nn.functional as F
    from xvr_tpu_torch.render import _cuda
    from xvr_tpu_torch.render import shearwarp as sw

    vol = projector.prepare_for_shearwarp()
    M, Wd, L = vol.shape
    records, calls = {}, []
    cases = stage_cases(projector, pose16, pose4)

    def f64(*xs):
        return [x.double() for x in xs]

    for label, pose, scale in cases:
        proj = projector.rescale_detector(scale)
        det = (proj.detector.height, proj.detector.width)
        x = path_inputs(proj, pose, seed=1)
        Iu, Iv = x["grid"]
        B, R = x["uc"].shape
        args = (x["s"], x["sgn"], x["u0"], x["du"], x["v0"], x["dv"])
        warp_args = (x["uc"], x["vc"], x["ws"])
        for eps in (1.0, 0.25):
            tag = f"{label} det {det[0]}x{det[1]} grid {Iu}x{Iv} eps {eps}"
            kw = dict(Iu=Iu, Iv=Iv, eps=eps)
            k1 = sw.accumulate(vol, *args, **kw)
            r1 = sw._accumulate(vol, *f64(*args), bf16=False, **kw)
            e1 = check("K1 sw_accumulate", k1.double(), r1, tag, 2e-5 * float(r1.abs().max()), 2e-4)
            same_bits("K1 sw_accumulate", k1, lambda: sw.accumulate(vol, *args, **kw), tag)
            log(f"    vs JAX bf16 recipe: {float((k1 - sw._accumulate(vol, *args, **kw)).abs().max()):.3e}")
            # K4 on the cotangent image of a random detector cotangent
            ibar = sw._warp_transpose(x["g"] * x["ws"], x["uc"], x["vc"], grid_shape=(Iu, Iv))
            k4 = sw.accumulate_adjoint(vol, *args, ibar, **kw)
            r4 = sw._accumulate_adjoint(vol, *args, ibar, bf16=False, **kw)
            e4 = check("K4 sw_accumulate_adjoint", k4, r4, tag, 1e-4 * float(r4.abs().max()), 1e-3)
            same_bits("K4 sw_accumulate_adjoint", k4,
                      lambda: sw.accumulate_adjoint(vol, *args, ibar, **kw), tag)
            log(f"    vs JAX bf16 recipe: {float((k4 - sw._accumulate_adjoint(vol, *args, ibar, **kw)).abs().max()):.3e}")
            if eps != 1.0:
                continue
            for name, grads in (("K2", False), ("K3", True)):
                threads, pix = _cuda.warp_plan(B, R, grads, _cuda.sm_count(k1.device))
                log(f"  {name} {tag}: plan {threads} threads x {pix} pixels per thread, "
                    f"{-(-B * R // (threads * pix))} blocks")
            e2, e3 = check_warps(k1, *warp_args, tag)

            # times at this shape (eps 1.0)
            reps = 20
            # library yardstick for the warps: grid_sample on the same image
            gx = (x["vc"] / (Iv - 1)) * 2 - 1
            gy = (x["uc"] / (Iu - 1)) * 2 - 1
            grid_n = torch.stack([gx, gy], -1).reshape(B, 1, R, 2)
            img = k1[:, None]
            grid_sample = partial(F.grid_sample, img, grid_n, mode="bilinear", align_corners=True)
            calls.append(dict(  # bound now: the loop variables move on
                sw_accumulate=partial(sw.accumulate, vol, *args, Iu=Iu, Iv=Iv, eps=eps),
                sw_accumulate_adjoint=partial(sw.accumulate_adjoint, vol, *args, ibar, Iu=Iu,
                                              Iv=Iv, eps=eps),
                sw_warp=partial(sw.warp, k1, *warp_args),
                sw_warp_grads=partial(sw.warp_with_grads, k1, *warp_args),
                grid_sample=grid_sample,
            ))
            t = {
                "sw_accumulate": (
                    time_ms(lambda: sw.accumulate(vol, *args, Iu=Iu, Iv=Iv, eps=eps), reps),
                    time_ms(lambda: sw._accumulate(vol, *args, Iu=Iu, Iv=Iv, eps=eps), 3),
                    None,
                ),
                "sw_accumulate_adjoint": (
                    time_ms(lambda: sw.accumulate_adjoint(vol, *args, ibar, Iu=Iu, Iv=Iv, eps=eps), reps),
                    time_ms(lambda: sw._accumulate_adjoint(vol, *args, ibar, Iu=Iu, Iv=Iv, eps=eps), 3),
                    None,
                ),
            }
            lib = time_ms(grid_sample, reps)
            t["sw_warp"] = (
                time_ms(lambda: sw.warp(k1, x["uc"], x["vc"], x["ws"]), reps),
                time_ms(lambda: sw._warp_plain(k1, x["uc"], x["vc"], x["ws"]), reps),
                lib,
            )
            t["sw_warp_grads"] = (
                time_ms(lambda: sw.warp_with_grads(k1, x["uc"], x["vc"], x["ws"]), reps),
                time_ms(lambda: sw._warp_with_grads_plain(k1, x["uc"], x["vc"], x["ws"]), reps),
                lib,
            )
            # bounds from this run's inputs
            n_act = active_samples((M, Wd, L), x)
            vol_b = M * Wd * L * 2
            bounds = {
                "sw_accumulate": (vol_b + B * 8 * 4 + B * Iu * Iv * 4, 8 * n_act),
                "sw_accumulate_adjoint": (vol_b + B * Iu * Iv * 2 + B * 8 * 4 + B * (Iu + Iv) * 4,
                                          16 * n_act),
                "sw_warp": (B * Iu * Iv * 4 + 4 * B * R * 4, 12 * B * R),
                "sw_warp_grads": (B * Iu * Iv * 4 + 6 * B * R * 4, 16 * B * R),
            }
            errs = {"sw_accumulate": e1, "sw_accumulate_adjoint": e4, "sw_warp": e2,
                    "sw_warp_grads": e3}
            for name, (ms, plain_ms, lib_ms) in t.items():
                nbytes, nops = bounds[name]
                t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_FLOPS * 1e3
                rec = dict(
                    name=name, route="cuda", source=SW_SOURCE, replaces=REPLACES[name],
                    launches=0, max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                    bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                    library_ms=lib_ms, shape=f"B={B} grid={Iu}x{Iv} det={det[0]}x{det[1]} eps={eps}",
                    B=B, det=det[0],
                )
                log(f"  time {name} [{rec['shape']}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"library {lib_ms if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
                    f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}: {nbytes / 1e6:.1f} MB, "
                    f"{nops / 1e9:.3f} GFLOP)")
                records.setdefault(name, []).append(rec)
    _cuda.reset_launches()
    return records, calls


def slab_pairs(vol_shape, fields) -> tuple[int, int]:
    """(ray, plane) pairs the slab kernels evaluate for these fields: the
    trilinear ones (K5-K7: slab weight > 0 and the sample inside the window
    and lane range) and the Siddon ones (K8: trimmed slab length > 0)."""
    from xvr_tpu_torch.render import pallas as sp

    M, Wd, L = vol_shape
    _, inv_d0, abs_d0 = sp._march(fields)
    half = 0.5 * inv_d0.abs()
    a_in, a_out = sp._box(fields, vol_shape)
    tri = sid = 0
    for k in range(M):
        _, _, _, valid = sp._slab_sample(fields, k, inv_d0, half, abs_d0, a_in, a_out, Wd, L)
        alpha = (float(k) - fields[0]) * inv_d0
        seg = (alpha + half).minimum(a_out) - (alpha - half).maximum(a_in)
        tri = tri + valid.sum()
        sid = sid + ((seg > 0) & (fields[6] > 0)).sum()
    return int(tri), int(sid)


FIELDS = ("s0", "s1", "s2", "d0", "d1", "d2", "ws")


def slab_path_inputs(projector, pose16, pose4):
    """The slab kernels' inputs at the registration's stage shapes
    (:func:`stage_cases`), as one render of each stage's poses makes them
    through ``projector`` (a ``with_pallas`` projector), with a random
    cotangent for K6. -> [dict(tag, det, fields (7, B, R), g (B, R), gen: the
    generator that made g)], coarse first, fine last."""
    import torch
    from xvr_tpu_torch.render import pallas as sp
    from xvr_tpu_torch.render import shearwarp as sw

    out = []
    for label, pose, scale in stage_cases(projector, pose16, pose4):
        proj = projector.rescale_detector(scale)
        with torch.no_grad():
            src, tgt = proj.rays(pose)
            fields = sp._fields(*sw._decompose(proj.affine_inverse, src, tgt, proj.pallas_perm))
        _, B, R = fields.shape
        gen = torch.Generator(device=fields.device).manual_seed(2)
        g = torch.randn((B, R), generator=gen, device=fields.device)
        det = (proj.detector.height, proj.detector.width)
        out.append(dict(tag=f"{label} det {det[0]}x{det[1]}", det=det, fields=fields, g=g, gen=gen))
    return out


def check_k5(k5, vol, fields, tag):
    """K5 against the float64 plain version: 2e-5 max|ref| + 2e-4 |ref|."""
    from xvr_tpu_torch.render import pallas as sp

    r5 = sp._slab_forward(vol, fields.double())
    return check("K5 slab_forward", k5.double(), r5, tag, 2e-5 * float(r5.abs().max()), 2e-4), r5


def check_k6(k6, vol, fields, g, tag):
    """K6 against the float32 plain version, field by field: 1e-4 max|ref| +
    1e-3 |ref|."""
    from xvr_tpu_torch.render import pallas as sp

    r6 = sp._slab_backward(vol, fields, g)
    return max(check(f"K6 slab_backward[{FIELDS[j]}]", k6[j], r6[j], tag,
                     1e-4 * float(r6[j].abs().max()), 1e-3) for j in range(7))


# K5-K8 geometry beyond the slab path's inputs: label -> (volume shape, B, R,
# kind). The rays of every case start from a source 30 planes before the
# volume with directions within ~30 degrees of the march axis, some of them
# clipped by the box, and 5 padding rays (ws = 0) per image; R is no multiple
# of a block's rays (32 to 256), so every grid has a ragged last block
SLAB_EDGE_CASES = {
    # |d0| of 2e-6 and 3e-6, and 5e-7 and 0 below the 1e-6 clamp: rays along
    # the planes, half of them with |d1|, |d2| small enough to sample
    "steep": ((24, 20, 28), 3, 300, "steep"),
    # d1 = 0 or d2 = 0 exactly, a quarter of them on a whole window row
    "parallel": ((24, 20, 28), 3, 300, "parallel"),
    "source inside": ((24, 20, 28), 3, 300, "inside"),
    # M = 19 (no multiple of the split), odd Wd and L
    "odd sizes": ((19, 21, 27), 3, 1000, "oblique"),
    "trainer batch": ((64, 40, 64), 116, 1000, "oblique"),  # the trainer's B = 116
}


def slab_edge_inputs(case, device="cuda", seed=7, B=None, R=None):
    """A bf16 volume and (7, B, R) f32 fields for one of SLAB_EDGE_CASES,
    from a fixed seed; ``B`` and ``R`` override the case's batch and rays."""
    import numpy as np
    import torch

    (M, Wd, L), B0, R0, kind = SLAB_EDGE_CASES[case]
    B, R = B or B0, R or R0
    rng = np.random.default_rng(seed)
    vol = torch.as_tensor(rng.uniform(0.0, 1.0, (M, Wd, L)), dtype=torch.float32,
                          device=device).to(torch.bfloat16)
    reach = M + 60.0
    s = np.stack([np.full((B, R), -30.0), rng.uniform(-4, Wd + 3, (B, R)),
                  rng.uniform(-4, L + 3, (B, R))])
    d = np.stack([np.full((B, R), reach), rng.uniform(-0.5, 0.5, (B, R)) * reach,
                  rng.uniform(-0.5, 0.5, (B, R)) * reach])
    if kind == "steep":
        s[0] = rng.uniform(-0.5, M - 0.5, (B, R))
        d[0] = rng.choice([2e-6, -3e-6, 5e-7, -5e-7, 0.0], (B, R))
        d[1:] = rng.uniform(-1.0, 1.0, (2, B, R)) * np.where(rng.random((B, R)) < 0.5, 1e-5, Wd)
    elif kind == "parallel":
        d[1, :, 0::2] = 0.0
        d[2, :, 1::2] = 0.0
        s[1, :, 0::4] = np.round(s[1, :, 0::4])
    elif kind == "inside":
        s = np.stack([rng.uniform(0, M - 1, (B, R)), rng.uniform(0, Wd - 1, (B, R)),
                      rng.uniform(0, L - 1, (B, R))])
    ws = rng.uniform(0.5, 2.0, (B, R))
    ws[:, :5] = 0.0
    fields = np.concatenate([s, d, ws[None]])
    return vol, torch.as_tensor(fields, dtype=torch.float32, device=device).contiguous()


def check_k7(k7, vol, lab, chans, fields, tag, r5):
    """K7 against the float32 plain version (1e-5 max|ref| + 1e-4 |ref|), and
    its channel sum against the float64 K5 ``r5`` with K5's tolerance."""
    from xvr_tpu_torch.render import pallas as sp

    r7 = sp._slab_channels(vol, lab, chans, fields)
    e7 = check("K7 slab_channels", k7, r7, tag, 1e-5 * float(r7.abs().max()), 1e-4)
    check("K7 channel sum vs float64 K5", k7.sum(1).double(), r5, tag,
          2e-5 * float(r5.abs().max()), 2e-4)
    return e7


def check_k8(k8, vol, fields, tag):
    """K8 against the float64 plain version: 1e-4 max|ref| + 1e-3 |ref|."""
    from xvr_tpu_torch.render import pallas as sp

    r8 = sp._slab_siddon(vol, fields.double())
    return check("K8 slab_siddon", k8.double(), r8, tag, 1e-4 * float(r8.abs().max()), 1e-3)


# K7's labels on the edge cases: bytes 0-3 and 255, channels for 1, 2 and 255
# (0 and 3 go to channel 0)
EDGE_LABELS, EDGE_CHANS = (0, 1, 2, 3, 255), (1, 2, 255)


def slab_edge_labels(shape, device="cuda", seed=9):
    """A uint8 labelmap of EDGE_LABELS from a fixed seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.choice(EDGE_LABELS, shape), dtype=torch.uint8, device=device)


def phase_edge_slab(seed=8, device="cuda"):
    """K5-K8 on SLAB_EDGE_CASES against their plain versions with the path's
    tolerances (see phase_slab_kernels), eleven calls bit-identical each.
    -> max abs error per kernel."""
    import torch
    from xvr_tpu_torch.render import _cuda
    from xvr_tpu_torch.render import pallas as sp

    errs = dict.fromkeys(("slab_forward", "slab_backward", "slab_channels", "slab_siddon"), 0.0)
    for label in SLAB_EDGE_CASES:
        vol, fields = slab_edge_inputs(label, device=device)
        lab = slab_edge_labels(vol.shape, device=device)
        _, B, R = fields.shape
        g = torch.randn((B, R), generator=torch.Generator(device=device).manual_seed(seed),
                        device=device)
        tag = (f"{label} vol {tuple(vol.shape)} B={B} R={R} "
               f"split {_cuda.slab_plane_split(B, R)}")
        k5 = sp.slab_forward(vol, fields)
        e5, r5 = check_k5(k5, vol, fields, tag)
        if not float(r5.abs().max()) > 0:
            raise AssertionError(f"{tag}: the case renders nothing")
        same_bits("K5 slab_forward", k5, partial(sp.slab_forward, vol, fields), tag)
        k6 = sp.slab_backward(vol, fields, g)
        e6 = check_k6(k6, vol, fields, g, tag)
        same_bits("K6 slab_backward", k6, partial(sp.slab_backward, vol, fields, g), tag)
        k7 = sp.slab_channels(vol, lab, EDGE_CHANS, fields)
        e7 = check_k7(k7, vol, lab, EDGE_CHANS, fields, tag, r5)
        same_bits("K7 slab_channels", k7, partial(sp.slab_channels, vol, lab, EDGE_CHANS, fields),
                  tag)
        k8 = sp.slab_siddon(vol, fields)
        e8 = check_k8(k8, vol, fields, tag)
        same_bits("K8 slab_siddon", k8, partial(sp.slab_siddon, vol, fields), tag)
        for name, e in (("slab_forward", e5), ("slab_backward", e6), ("slab_channels", e7),
                        ("slab_siddon", e8)):
            errs[name] = max(errs[name], e)
    _cuda.reset_launches()
    return errs


def phase_slab_kernels(projector, pose16, pose4, labels, chans=(1, 2), time_ms=cuda_time_ms):
    """K5-K8 against their plain versions at the slab path's shapes (the
    coarse sweep's B=16 at 60^2, then B=4 at 60^2, 120^2 and 239^2), each
    also held bit for bit over eleven calls.

    References: K5 and K8 sum positive terms, so their plain versions run in
    float64. K6 sums signed terms with tent slopes that flip where a sample
    crosses a window row, so a one-ulp position change flips a term: its
    reference is the float32 plain version with every operation rounded as
    the kernel rounds it, and it is also held against a central difference
    of the float64 K5 along a random direction. K7's nearest-label rounding jumps at half-integers, so it is
    held against the float32 plain version, and its channel sum against the
    float64 K5. Tolerances (atol relative to max|ref|, plus rtol): K5 2e-5 +
    2e-4 (f32 accumulation over <= 256 planes), K7 1e-5 + 1e-4 and its sum as
    K5, K6 1e-4 + 1e-3 per field, K8 1e-4 + 1e-3, the difference 1e-2 of the
    directional derivative.

    -> (records per kernel, one per shape; one call per kernel and shape for
    the profiler)."""
    import torch
    from xvr_tpu_torch.render import _cuda
    from xvr_tpu_torch.render import pallas as sp

    vol, vol_shape = projector.pack_for_pallas()
    M, Wd, L = vol_shape
    lab = sp.pack_labels(labels, projector.pallas_perm)
    C = len(chans) + 1
    records, calls = {}, []
    for x in slab_path_inputs(projector, pose16, pose4):
        tag, det, fields, g, gen = x["tag"], x["det"], x["fields"], x["g"], x["gen"]
        _, B, R = fields.shape
        f64 = fields.double()
        log(f"  K5-K8 {tag}: {_cuda.slab_plane_split(B, R)} warps share a ray's planes")

        k5 = sp.slab_forward(vol, fields)
        e5, r5 = check_k5(k5, vol, fields, tag)
        same_bits("K5 slab_forward", k5, partial(sp.slab_forward, vol, fields), tag)

        k6 = sp.slab_backward(vol, fields, g)
        e6 = check_k6(k6, vol, fields, g, tag)
        same_bits("K6 slab_backward", k6, partial(sp.slab_backward, vol, fields, g), tag)
        # distance to float64 arithmetic throughout (positions included)
        r6_64 = sp._slab_backward(vol, f64, g.double())
        scale64 = r6_64.abs().amax(dim=(1, 2))[:, None, None]
        log(f"    vs float64 throughout: max |err| / max |ref| over fields "
            f"{float(((k6 - r6_64).abs() / scale64).max()):.3e}")
        # directional derivative against a central difference of K5 on a few rays
        mid = slice(max(R // 2 - 128, 0), min(R // 2 + 128, R))
        sub = fields[:, :1, mid].contiguous()
        e_dir = torch.randn(sub.shape, generator=gen, device=sub.device, dtype=torch.float64)
        e_dir[6] *= float(sub[6].abs().mean())
        gs = torch.randn(sub.shape[1:], generator=gen, device=sub.device)
        an = float((sp.slab_backward(vol, sub, gs).double() * e_dir).sum())
        h = 1e-6
        plus = (sp._slab_forward(vol, sub.double() + h * e_dir) * gs).sum()
        minus = (sp._slab_forward(vol, sub.double() - h * e_dir) * gs).sum()
        fd = float((plus - minus) / (2 * h))
        rel = abs(an - fd) / max(abs(fd), 1e-30)
        log(f"  K6 vs central difference of K5 {tag} ({sub.shape[2]} rays): analytic {an:.6e} "
            f"fd {fd:.6e} rel {rel:.3e} (< 1e-2) {'OK' if rel < 1e-2 else 'FAIL'}")
        if not rel < 1e-2:
            raise AssertionError(f"K6 disagrees with a finite difference of K5 ({rel})")

        k7 = sp.slab_channels(vol, lab, chans, fields)
        e7 = check_k7(k7, vol, lab, chans, fields, tag, r5)
        same_bits("K7 slab_channels", k7, partial(sp.slab_channels, vol, lab, chans, fields), tag)
        nonzero = [int((k7[:, c] > 0).sum()) for c in range(C)]
        log(f"    pixels > 0 per channel: {nonzero}")

        k8 = sp.slab_siddon(vol, fields)
        e8 = check_k8(k8, vol, fields, tag)
        same_bits("K8 slab_siddon", k8, partial(sp.slab_siddon, vol, fields), tag)

        # times at this shape
        reps = 20
        calls.append(dict(  # bound now: the loop variables move on
            slab_forward=partial(sp.slab_forward, vol, fields),
            slab_backward=partial(sp.slab_backward, vol, fields, g),
            slab_channels=partial(sp.slab_channels, vol, lab, chans, fields),
            slab_siddon=partial(sp.slab_siddon, vol, fields),
        ))
        plain = dict(
            slab_forward=partial(sp._slab_forward, vol, fields),
            slab_backward=partial(sp._slab_backward, vol, fields, g),
            slab_channels=partial(sp._slab_channels, vol, lab, chans, fields),
            slab_siddon=partial(sp._slab_siddon, vol, fields),
        )
        errs = {"slab_forward": e5, "slab_backward": e6, "slab_channels": e7, "slab_siddon": e8}
        pairs = slab_pairs(vol_shape, fields)
        for name, call in calls[-1].items():
            ms, plain_ms = time_ms(call, reps), time_ms(plain[name], 2, warmup=1)
            rec = slab_record(name, vol_shape, fields, C, errs[name], ms, plain_ms,
                              f"B={B} det={det[0]}x{det[1]} vol={M}x{Wd}x{L}", pairs)
            records.setdefault(name, []).append(rec)
    _cuda.reset_launches()
    return records, calls


def slab_record(name, vol_shape, fields, C, err, ms, plain_ms, shape, pairs):
    """The JSON record of one slab kernel at one shape, with its bound from
    ``pairs`` (slab_pairs of these fields), and one line of it; K7 and K8
    also under SLAB_OPS_FULL_PLANE."""
    M, Wd, L = vol_shape
    _, B, R = fields.shape
    tri, sid = pairs
    n_pairs = sid if name == "slab_siddon" else tri
    vol_b, ray_b = M * Wd * L * 2, B * R * 4
    nbytes = {"slab_forward": vol_b + 8 * ray_b, "slab_backward": vol_b + 15 * ray_b,
              "slab_channels": vol_b + M * Wd * L + (7 + C) * ray_b,
              "slab_siddon": vol_b + 8 * ray_b}[name]

    def bound(ops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops * n_pairs / F32_FLOPS * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    bound_ms, bound_by = bound(SLAB_OPS[name])
    rec = dict(
        name=name, route="cuda", source=SLAB_SOURCE, replaces=REPLACES[name], launches=0,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, shape=shape, B=B, det=int(round(R ** 0.5)),
    )
    full = ""
    if name in SLAB_OPS_FULL_PLANE:
        rec["bound_ms_full_plane_ops"], by = bound(SLAB_OPS_FULL_PLANE[name])
        full = (f"; {rec['bound_ms_full_plane_ops']:.4f} ms ({by}) at "
                f"{SLAB_OPS_FULL_PLANE[name]} operations per pair")
    log(f"  time {name} [{shape}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
        f"{SLAB_OPS[name] * n_pairs / 1e9:.3f} GFLOP at {SLAB_OPS[name]} operations over "
        f"{n_pairs} pairs){full}")
    return rec


# the trainer's finetune operating point (README.md: batch 116 at 128^2,
# sdd 1020, delx 2.1764375), where the masked fallback renders through K7
TRAINER = dict(B=116, height=128, delx=2.1764375, sdd=1020.0)
TRAINER_CHECKED = 8  # images held against the plain versions


def trainer_inputs(volume, seed=4):
    """K7's and K8's inputs at the trainer's shape on the bench volume:
    TRAINER["B"] poses within +-5 degrees and +-20 mm of the GT pose (numpy
    seed), rendered by a ``with_pallas`` projector. -> (bf16 volume, uint8
    labels, (7, B, R) fields)."""
    import numpy as np
    import torch
    from xvr_tpu_torch.geometry import convert
    from xvr_tpu_torch.render import Projector
    from xvr_tpu_torch.render import pallas as sp
    from xvr_tpu_torch.render import shearwarp as sw

    dev = volume.data.device
    rng = np.random.default_rng(seed)
    B = TRAINER["B"]
    rot = np.deg2rad([182.0, -4.0, 3.0]) + np.deg2rad(rng.uniform(-5, 5, (B, 3)))
    xyz = np.array([6.0, 740.0, -10.0]) + rng.uniform(-20, 20, (B, 3))
    pose = convert(torch.tensor(rot, dtype=torch.float32, device=dev),
                   torch.tensor(xyz, dtype=torch.float32, device=dev), "euler_angles", "ZXY")
    proj = Projector.from_volume(volume, sdd=TRAINER["sdd"], height=TRAINER["height"],
                                 delx=TRAINER["delx"]).with_pallas(pose[:1])
    if proj.renderer != "trilinear_pallas":
        raise AssertionError(f"with_pallas declined the trainer's poses: {proj.renderer}")
    with torch.no_grad():
        src, tgt = proj.rays(pose)
        fields = sp._fields(*sw._decompose(proj.affine_inverse, src, tgt, proj.pallas_perm))
    return proj.pack_for_pallas()[0], sp.pack_labels(volume.mask, proj.pallas_perm), fields


def phase_trainer_shape(volume, chans=(1, 2), time_ms=cuda_time_ms):
    """K7 and K8 at the trainer's shape: held against their plain versions
    (phase_slab_kernels' tolerances) on the first TRAINER_CHECKED images,
    eleven calls bit-identical, and timed on all TRAINER["B"] (CUDA events,
    torch.profiler device time alone, one plain call). -> name -> record."""
    from xvr_tpu_torch.render import _cuda
    from xvr_tpu_torch.render import pallas as sp

    vol, lab, fields = trainer_inputs(volume)
    vol_shape = tuple(vol.shape)
    _, B, R = fields.shape
    n = TRAINER_CHECKED
    head = fields[:, :n].contiguous()
    tag = f"trainer B={B} det {TRAINER['height']}^2 (first {n} checked)"
    log(f"  K7/K8 {tag}: {_cuda.slab_plane_split(B, R)} warps share a ray's planes")
    r5 = sp._slab_forward(vol, head.double())
    k7 = sp.slab_channels(vol, lab, chans, fields)
    e7 = check_k7(k7[:n].contiguous(), vol, lab, chans, head, tag, r5)
    same_bits("K7 slab_channels", k7, partial(sp.slab_channels, vol, lab, chans, fields), tag)
    k8 = sp.slab_siddon(vol, fields)
    e8 = check_k8(k8[:n].contiguous(), vol, head, tag)
    same_bits("K8 slab_siddon", k8, partial(sp.slab_siddon, vol, fields), tag)
    pairs = slab_pairs(vol_shape, fields)
    calls = {"slab_channels": (partial(sp.slab_channels, vol, lab, chans, fields),
                               partial(sp._slab_channels, vol, lab, chans, fields), e7),
             "slab_siddon": (partial(sp.slab_siddon, vol, fields),
                             partial(sp._slab_siddon, vol, fields), e8)}
    out = {}
    for name, (call, plain, err) in calls.items():
        rec = slab_record(name, vol_shape, fields, len(chans) + 1, err, time_ms(call, 20),
                          time_ms(plain, 1, warmup=0), f"B={B} det={TRAINER['height']}^2 "
                          f"vol={'x'.join(map(str, vol_shape))} (trainer)", pairs)
        dev_ms = rec["profiler_ms"] = library_device_ms(call)[0]
        log(f"  profiler {name} [{rec['shape']}]: device "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} per call (alone)")
        out[name] = rec
    _cuda.reset_launches()
    return out


# ---------------------------------------------------------------------------
# phase 4: the slices
# ---------------------------------------------------------------------------


def counted(names, fn):
    """Run ``fn`` with every launch count set to 0 just before it; -> (its
    result, the counts of ``names`` just after). Fails if one is 0."""
    import torch
    from xvr_tpu_torch.render import _cuda

    _cuda.reset_launches()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    missing = [k for k in names if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on this path: {missing} ({launches})")
    return out, launches


def write_scene(workdir: Path, hu, aff, dev="cuda", det=1436):
    """Write the CT and the shear-warp render of the GT pose as a DICOM
    X-ray; check the fast, slab and Siddon renders against the golden ones
    at 96^2. -> (GT pose, its shear-warp projector, the GT image)."""
    import numpy as np
    import torch
    from xvr_tpu_torch.geometry import convert
    from xvr_tpu_torch.io import dcmwrite, read, save_nifti
    from xvr_tpu_torch.render import Projector
    from xvr_tpu_torch.render import xla

    SDD, H, DELX = 1020.0, det, 0.194 * 1436 / det
    t0 = time.perf_counter()
    save_nifti(workdir / "ct.nii.gz", hu, aff)
    vol = read(workdir / "ct.nii.gz", device=dev)
    proj = Projector.from_volume(vol, sdd=SDD, height=H, delx=DELX)
    gt_pose = convert(torch.tensor([[182.0, -4.0, 3.0]], device=dev),
                      torch.tensor([[6.0, 740.0, -10.0]], device=dev),
                      "euler_angles", "ZXY", degrees=True)
    gt_proj = proj.with_shearwarp(gt_pose, differentiable=False)
    if gt_proj.renderer != "trilinear_shearwarp":
        raise AssertionError(f"GT render did not take shear-warp: {gt_proj.renderer}")
    with torch.no_grad():
        img = gt_proj(gt_pose)[0, 0].cpu().numpy()
    if img.shape != (H, H) or not np.isfinite(img).all() or img.max() <= 0:
        raise AssertionError(f"bad GT render: shape {img.shape}, max {img.max()}")
    dcmwrite(workdir / "xray.dcm", (img / img.max() * 60000).astype(np.uint16),
             sdd=SDD, row_spacing=DELX, col_spacing=DELX)
    log(f"slices: phantom CT + {H}^2 GT X-ray ({gt_proj.renderer}) written in "
        f"{time.perf_counter() - t0:.1f} s")

    # against the golden renderers on a small detector, with the JAX
    # package's bounds: trilinear max error < 2% of max and correlation
    # > 0.9999; Siddon max error < 1% of max (tests/test_pallas.py)
    small = gt_proj.rescale_detector(H / 96)
    with torch.no_grad():
        src, tgt = small.rays(gt_pose)
        gold = xla.raymarch_trilinear(small.density, small.affine_inverse, src, tgt,
                                      n_samples=512).reshape(1, 1, 96, 96)
        gold_s = xla.raymarch_siddon(small.density, small.affine_inverse, src, tgt)
        renders = {
            "fast": small.replace(renderer="trilinear_fast")(gt_pose),
            "slab": small.replace(renderer="trilinear_pallas")(gt_pose),
        }
        sid = small.replace(renderer="siddon_pallas")(gt_pose).reshape(gold_s.shape)
    for name, out in renders.items():
        rel = float((out - gold).abs().max() / gold.abs().max())
        corr = float(np.corrcoef(out.cpu().numpy().ravel(), gold.cpu().numpy().ravel())[0, 1])
        log(f"slices: {name} vs golden trilinear at 96^2: max rel err {rel:.4f} (< 0.02), "
            f"corr {corr:.6f} (> 0.9999)")
        if not (rel < 0.02 and corr > 0.9999):
            raise AssertionError(f"{name} render disagrees with the golden renderer")
    rel = float((sid - gold_s).abs().max() / gold_s.abs().max())
    log(f"slices: siddon_pallas vs golden Siddon at 96^2: max rel err {rel:.5f} (< 0.01)")
    if not rel < 0.01:
        raise AssertionError("siddon_pallas disagrees with the golden Siddon renderer")
    return gt_pose, gt_proj, img


def register(workdir: Path, gt_pose, fids, renderer, kernels, no_shearwarp=False, dev="cuda",
             n_itrs="500,500,500"):
    """Register the scene's X-ray with the bench's configuration from the
    ~4 mm init, with the launch counts of this run alone. Checks the
    renderer, that ``kernels`` launched and the others did not, and mTRE
    < 1 mm. -> (launches, stats)."""
    import numpy as np
    from xvr_tpu_torch.registrar import RegistrarFixed
    from xvr_tpu_torch.render import _cuda

    gt_np = gt_pose.matrix[0].cpu().numpy()
    rot0, xyz0 = gt_pose.convert("euler_angles", "ZXY")
    rot_init = (rot0[0].cpu().numpy() + np.deg2rad([0.6, -0.5, 0.4])).tolist()
    xyz_init = (xyz0[0].cpu().numpy() + np.array([2.0, -3.0, 1.5])).tolist()
    saved = os.environ.pop("XVR_NO_SHEARWARP", None)
    if no_shearwarp:
        os.environ["XVR_NO_SHEARWARP"] = "1"
    try:
        reg = RegistrarFixed(
            volume=workdir / "ct.nii.gz", mask=None, orientation="AP",
            rot=rot_init, xyz=xyz_init,
            linearize=False, scales="24,12,6", n_itrs=n_itrs, crop=100,
            reverse_x_axis=False, lr_rot=1e-2, lr_xyz=1.0,
            patience=10, max_n_plateaus=3, verbose=1, coarse_seeds=16, device=dev,
        )
        t0 = time.perf_counter()
        out, launches = counted(kernels, lambda: reg.run(workdir / "xray.dcm"))
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("XVR_NO_SHEARWARP", None)
        if saved is not None:
            os.environ["XVR_NO_SHEARWARP"] = saved
    tag = f"slice {renderer}"
    log(f"{tag}: renderer {reg.projector.renderer}, wall {wall:.2f} s, "
        f"launches {json.dumps(launches)}")
    for rec in reg.stage_log:
        log(f"  stage {rec['stage']} K={rec['K']} {rec['height']}x{rec['width']} "
            f"{rec['renderer']}: {rec['n_done']} itrs, {rec['ms_per_itr']:.2f} ms/itr")
    m_init = fiducial_mtre(out[3].matrix.cpu().numpy(), gt_np, fids)
    m_final = fiducial_mtre(out[4].matrix.cpu().numpy(), gt_np, fids)
    log(f"{tag}: mTRE init {m_init:.3f} mm -> final {m_final:.3f} mm (< 1 mm)")
    if reg.projector.renderer != renderer:
        raise AssertionError(f"registration ran {reg.projector.renderer}, not {renderer}")
    stray = [k for k, v in launches.items() if v and k not in kernels]
    if stray:
        raise AssertionError(f"kernels of another path launched: {stray}")
    if not m_final < 1.0:
        raise AssertionError(f"final mTRE {m_final:.3f} mm >= 1 mm")
    stages = [dict(stage=r["stage"], K=r["K"], det=r["height"], n_done=r["n_done"],
                   ms_per_itr=r["ms_per_itr"]) for r in reg.stage_log]
    return launches, dict(wall_s=wall, mtre_init_mm=m_init, mtre_final_mm=m_final,
                          n_itrs=n_itrs, stages=stages)


def label_and_siddon_renders(volume, gt_pose, gt_proj, gt_img, pose4, chans=(1, 2),
                             time_ms=cuda_time_ms):
    """A labelmap render through ``Projector(labels=...)`` with the slab
    kernels at the fine stage, forward and backward (K7, K6), and the
    ``siddon_pallas`` render of the GT pose at full size (K8), each with
    the launch counts of its own run. -> (launches per kernel, stats)."""
    import numpy as np
    import torch
    from xvr_tpu_torch.geometry import convert
    from xvr_tpu_torch.registrar.base import _parse_scales
    from xvr_tpu_torch.render import Projector
    from xvr_tpu_torch.render import pallas as sp
    from xvr_tpu_torch.render import shearwarp as sw

    det = gt_proj.detector
    crop = 100  # the registration's: its fine stage renders 239^2 of the 1336^2 crop
    base = Projector.from_volume(volume, sdd=det.sdd, height=det.height - crop, delx=det.delx,
                                 labels=chans)
    fine = base.rescale_detector(_parse_scales("24,12,6", crop, base.detector.height)[2])
    fine = fine.with_pallas(pose4)
    if fine.renderer != "trilinear_pallas":
        raise AssertionError(f"label render did not take the slab kernels: {fine.renderer}")
    rot, xyz = (x.detach().clone().requires_grad_(True) for x in pose4.convert("euler_angles", "ZXY"))

    def label_render():
        img = fine(convert(rot, xyz, "euler_angles", "ZXY"))
        (img.sum(dim=1) ** 2).mean().backward()
        return img.detach()

    img, l7 = counted(("slab_channels", "slab_backward"), label_render)
    # the channels partition the render: their sum against the float64 K5 with
    # K5's tolerance (K7 and K5 round differently since K5's redesign)
    with torch.no_grad():
        src, tgt = fine.rays(convert(rot, xyz, "euler_angles", "ZXY"))
        fields = sp._fields(*sw._decompose(fine.affine_inverse, src, tgt, fine.pallas_perm))
        packed = fine.pack_for_pallas()[0]
        r5 = sp._slab_forward(packed, fields.double()).reshape(img.shape[0], *img.shape[2:])
        k5 = sp.slab_forward(packed, fields).reshape(r5.shape)
    ch_sum = img.sum(dim=1).double()
    err = (ch_sum - r5).abs()
    tol = 2e-5 * float(r5.abs().max()) + 2e-4 * r5.abs()
    per_ch = [float(img[:, c].sum() / img.sum()) for c in range(img.shape[1])]
    log(f"slices: label render {tuple(img.shape)} via {fine.renderer}: channel shares "
        f"{[round(p, 4) for p in per_ch]}, |sum of channels - float64 K5| max "
        f"{float(err.max()):.3e} (<= 2e-5 * {float(r5.abs().max()):.3f} + 2e-4 |ref|; K5 kernel "
        f"{float((ch_sum - k5).abs().max()):.3e}), launches {json.dumps(l7)}")
    if not (torch.isfinite(img).all() and torch.isfinite(rot.grad).all()
            and float(rot.grad.abs().sum()) > 0 and bool((err <= tol).all())):
        raise AssertionError("label render: non-finite output, zero gradient or channel sum off")
    diff = float(err.max())
    # a label render packs the labelmap (pack_labels) and then runs K7
    lab = sp.pack_labels(volume.mask, fine.pallas_perm)
    pack_ms = time_ms(lambda: sp.pack_labels(volume.mask, fine.pallas_perm), 10)
    k7_ms = time_ms(lambda: sp.slab_channels(packed, lab, chans, fields), 10)
    log(f"slices: per label render, pack_labels {pack_ms:.4f} ms beside K7 {k7_ms:.4f} ms "
        f"(CUDA events, 10 calls each)")

    sid_proj = gt_proj.replace(renderer="siddon_pallas")
    with torch.no_grad():
        sid, l8 = counted(("slab_siddon",), lambda: sid_proj(gt_pose)[0, 0])
    sid = sid.cpu().numpy()
    corr = float(np.corrcoef(sid.ravel(), gt_img.ravel())[0, 1])
    log(f"slices: siddon_pallas GT render {sid.shape}: max {sid.max():.3f}, corr with the "
        f"shear-warp GT X-ray {corr:.6f} (> 0.95), launches {json.dumps(l8)}")
    # the exact check of K8 is the 96^2 one against the golden Siddon; at full
    # size the piecewise-constant image only has to be the same scene
    if sid.shape != gt_img.shape or not np.isfinite(sid).all() or not corr > 0.95:
        raise AssertionError("siddon_pallas GT render is off")
    return ({"slab_channels": l7["slab_channels"], "slab_siddon": l8["slab_siddon"]},
            dict(label_channel_shares=per_ch, label_sum_err=diff, siddon_corr=corr,
                 pack_labels_ms=pack_ms, label_k7_ms=k7_ms))


SW_KERNELS = ("sw_accumulate", "sw_warp", "sw_warp_grads", "sw_accumulate_adjoint")
SLAB_PATH = ("slab_forward", "slab_backward")


def stage_gaps(records, sw_stats, slab_stats, launches):
    """Device time above the bound per registration, in ms: for the kernels of
    each registration, the sum over its stages of the stage's iterations (an
    iteration launches each kernel of its path once) times (device time -
    bound) at the stage's shape; for K7 and K8, their launches at the fine
    shape. -> name -> (gap ms or None without device times, iterations)."""
    out = {}
    for name, recs in records.items():
        stats = sw_stats if name in SW_KERNELS else slab_stats if name in SLAB_PATH else None
        if stats is None:
            rec = recs[-1]
            runs = [(launches[name], rec)]
        else:
            by_shape = {(r["B"], r["det"]): r for r in recs}
            runs = [(st["n_done"], by_shape[(st["K"], st["det"])]) for st in stats["stages"]]
        if any(r.get("profiler_ms") is None for _, r in runs):
            out[name] = (None, sum(n for n, _ in runs))
            continue
        out[name] = (sum(n * (r["profiler_ms"] - r["bound_ms"]) for n, r in runs),
                     sum(n for n, _ in runs))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "xvr_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    t_start = time.perf_counter()

    # 1. device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    from xvr_tpu_torch.render import _cuda

    _cuda.build(verbose=True)
    log(f"build: {_cuda.BUILD_INFO['seconds']:.1f} s -> {_cuda.BUILD_INFO['path']}")
    for line in _cuda.BUILD_INFO["log"].splitlines():
        if "ptxas" in line and ("registers" in line or "Compiling" in line or "spill" in line):
            log(f"  {line.strip()}")

    # 3. kernels at the paths' shapes, on the bench scene
    t0 = time.perf_counter()
    hu, aff, fids = build_phantom(256)
    log(f"phantom: 256^3 built in {time.perf_counter() - t0:.1f} s")
    vol, proj, pose16, pose4 = bench_projector(hu, aff)
    sw_proj = proj.with_shearwarp(pose16[:1])
    slab_proj = proj.with_pallas(pose16[:1])
    log(f"kernels: volume perm {sw_proj.pallas_perm} ({sw_proj.renderer}), "
        f"{slab_proj.pallas_perm} ({slab_proj.renderer})")
    if slab_proj.renderer != "trilinear_pallas":
        raise AssertionError(f"with_pallas declined the bench poses: {slab_proj.renderer}")
    records, sw_calls = phase_kernels(sw_proj, pose16, pose4)
    edge_errs = phase_edge_kernels(sw_proj.prepare_for_shearwarp())
    edge_errs.update(phase_edge_slab())
    slab_records, slab_calls = phase_slab_kernels(slab_proj, pose16, pose4, vol.mask)
    records.update(slab_records)
    trainer = phase_trainer_shape(vol)
    # device time of every kernel at each shape; grid_sample, K2 and K3 also
    # each profiled alone, so that K2/K3 and their library call compare alike
    fmt = lambda ms: "not measured" if ms is None else f"{ms:.4f} ms"  # noqa: E731
    for idx, calls in enumerate(zip(sw_calls, slab_calls)):
        lib, lib_names = library_device_ms(calls[0].pop("grid_sample"))
        for name in ("sw_warp", "sw_warp_grads"):
            records[name][idx]["library_profiler_ms"] = lib
            records[name][idx]["alone_profiler_ms"] = library_device_ms(calls[0][name])[0]
        log(f"  profiler grid_sample (K2/K3's library call) [{records['sw_warp'][idx]['shape']}]: "
            f"device {fmt(lib)} per call over {lib_names}, CUDA events "
            f"{records['sw_warp'][idx]['library_ms']:.4f} ms; profiled alone as it is, K2 "
            f"{fmt(records['sw_warp'][idx]['alone_profiler_ms'])}, K3 "
            f"{fmt(records['sw_warp_grads'][idx]['alone_profiler_ms'])}")
        prof = profiler_ms({**calls[0], **calls[1]})
        for name, ms in prof.items():
            records[name][idx]["profiler_ms"] = ms
            log(f"  profiler {name} [{records[name][idx]['shape']}]: device "
                f"{'not measured' if ms is None else f'{ms:.4f} ms'} per call, CUDA events "
                f"{records[name][idx]['ms']:.4f} ms")
    log(f"kernels: all checks passed ({time.perf_counter() - t0:.1f} s)")

    # 4. the slices, each with the launch counts of its own run
    with tempfile.TemporaryDirectory(prefix="xvr_chip_smoke_") as tmp:
        workdir = Path(tmp)
        gt_pose, gt_proj, gt_img = write_scene(workdir, hu, aff)
        sw_launches, sw_stats = register(workdir, gt_pose, fids, "trilinear_fast", SW_KERNELS)
        slab_launches, slab_stats = register(workdir, gt_pose, fids, "trilinear_pallas",
                                             SLAB_PATH, no_shearwarp=True)
    render_launches, render_stats = label_and_siddon_renders(vol, gt_pose, gt_proj, gt_img, pose4)
    launches = {**{k: sw_launches[k] for k in sw_launches if k.startswith("sw_")},
                "slab_forward": slab_launches["slab_forward"],
                "slab_backward": slab_launches["slab_backward"], **render_launches}

    # launches x (device - bound) per registration, stage by stage
    gaps = stage_gaps(records, sw_stats, slab_stats, launches)
    for name, (gap, n) in sorted(gaps.items(), key=lambda kv: -(kv[1][0] or 0.0)):
        log(f"gap {name}: {'not measured' if gap is None else f'{gap:.1f} ms'} above the bound "
            f"per registration over {n} iterations or launches ({launches[name]} launches)")

    # one record per kernel: the fine stage's shape, the coarse one beside it
    kernels = []
    for name, recs in records.items():
        rec = dict(recs[-1])
        rec["launches"] = launches[name]
        rec["max_abs_err"] = max(r["max_abs_err"] for r in recs)
        rec["edge_max_abs_err"] = edge_errs.get(name)
        rec["gap_ms_per_registration"] = gaps[name][0]
        rec["coarse"] = {k: recs[0].get(k) for k in ("shape", "ms", "profiler_ms", "bound_ms",
                                                     "bound_ms_full_plane_ops", "plain_ms", "library_ms",
                                                     "library_profiler_ms", "alone_profiler_ms")}
        rec["stages"] = [{k: r.get(k) for k in ("shape", "ms", "profiler_ms", "bound_ms",
                                                "bound_ms_full_plane_ops", "library_ms",
                                                "library_profiler_ms", "alone_profiler_ms")}
                         for r in recs]
        if name in trainer:
            rec["trainer"] = {k: trainer[name].get(k) for k in (
                "shape", "ms", "profiler_ms", "plain_ms", "bound_ms", "bound_by",
                "bound_ms_full_plane_ops", "max_abs_err")}
        kernels.append(rec)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print("slices " + json.dumps({"shearwarp": sw_stats, "slab": slab_stats, "renders": render_stats}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
