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
``siddon_pallas`` render of the ground-truth pose runs K8. Then the user's
entry point, ``python -m xvr_tpu_torch.cli register model|restart|dicom``,
runs in process on the same scene from a synthetic ResNet-34 checkpoint, and
``python -m xvr_tpu_torch.cli train|restart`` trains the pose CNN on the CT
with a two-label mask (finetune configuration, batch 116 at 128^2). Last,
the published DeepFluoro register and evaluate runs of ``scripts/torch``
run in process on a subject written in the converted-dataset layout.

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
             alone as grid_sample is; the rays' pose adjoint (rays_adjoint)
             at the same four shapes on a render's own ray cotangent,
             against its plain version in float64, eleven calls
             bit-identical, its times beside its byte bound and beside the
             batched GEMM it replaces (library); the content boxes K1/K4
             skip by (sw_content_boxes) on the bench volume and the
             trainer's channel stack, equal to their plain version, with
             their times and byte bound (one "content_boxes" JSON line at
             the end, with their launches on each path)
4. slices    GT render; the shear-warp and slab registrations, each with the
             launch counts of its own run and its mTRE; the label and Siddon
             renders, each with its launch counts (and pack_labels' time per
             label render beside K7's); each kernel's device time above its
             bound per registration, stage by stage
5. entry     the CLI in process, in the same scene: a ResNet-34 checkpoint
             (random seeded weights, heads set a few mm off the GT) written
             in the JAX layout, its forward on the card against the CPU and
             its time; ``register model`` with phase 4's configuration
             (launches of K1-K4 alone, init = the CNN's pose, mTRE < 1 mm),
             ``register restart`` from its bundle (init = its final pose bit
             for bit, mTRE < 1 mm) and ``register dicom --init_only`` (init
             = the positioner tags' pose); each command's wall time
6. train     K1-K4 at the trainer's shape (B=116 poses of the finetune
             ranges at 128^2; in phase 3's block): single-channel and as the
             two-label stack with its slab bounds, against their plain
             versions on 8 images per channel, eleven calls bit-identical,
             CUDA-event and profiler times beside their bounds. Then the CLI
             in process: ``train`` masked with the finetune configuration
             (ResNet-34, batch 116 at 128^2, 12 steps, a checkpoint every
             6), ``train`` unmasked with bench_train's ranges (6 steps) and
             ``restart`` from the masked run's step-6 checkpoint: the route,
             host ms per step, device ms per step by kernel and the rest,
             launches per step against the route's, peak memory, loss and
             kept share per step; the restart's iteration and optimizer
             state against its checkpoint
7. rest      on phase 4's scene: raymarch_trilinear_scan against
             raymarch_trilinear at the fine stage (B=4, 239^2), max error,
             times and peak memory; ray_sharded_fast_render on a 4-slot mesh
             of the one card (rays 2) at B=1 and B=4, bit for bit against
             the unsharded render, its pose gradient, K1-K4 launches per
             call; RegistrarFixed.run_batch([xray] * 3) on a 2-slot mesh
             (padded to 4; phase 4's registrar with fewer iterations) against
             the mesh-free run; phase 6's finetune Trainer on a 2-slot mesh,
             8 steps, step 1's loss against the mesh-free step's, ms and
             launches per step; animate's render_trajectory over phase 5's
             restart bundle (~20 frames, 3 held against the CPU); dcm2nii
             through the CLI on a 16x12x8 series
8. workflows scripts/torch's DeepFluoro runs on a synthetic subject in
             the layout convert_datasets.py writes (the bench CT with a
             seven-label mask whose labels 5 and 6 hold under 10% of the
             bone, two 1436^2 X-rays of the whole CT rendered at two poses,
             a synthetic finetuned checkpoint; K1-K4 at its shapes, B=8 on
             the masked density, in phase 3's block): the xvr-torch line of
             deepfluoro/register/finetuned.sh as published (crop 100,
             --linearize, --labels 1,2,3,4,7, scales 24,12,6 x 500; K1-K4
             launch counts of its run, the masked density packed for K1,
             mTRE < 1 mm, the objective at GT and at the final pose), the
             loop of deepfluoro/evaluate/finetuned.sh (--warp --init_only,
             no kernel; the identity warp leaves the init pose bit for bit)
             and its evaluate line, evaluate.py on the register run (its
             mTRE the registrar's poses' within 1e-3 mm) and
             validate_convention.py (exit 0); a ``workflows`` line with each
             command's wall time beside the card's name and power limit

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
F64_FLOPS = 34e12  # H100 SXM float64 outside the tensor cores
SW_SOURCE = "xvr_tpu_torch/csrc/shearwarp.cu"
SLAB_SOURCE = "xvr_tpu_torch/csrc/slab.cu"
RAYS_SOURCE = "xvr_tpu_torch/csrc/rays.cu"
REPLACES = {
    "sw_accumulate": "xvr_tpu/render/shearwarp.py:222",
    "sw_warp": "xvr_tpu/render/shearwarp.py:368",
    "sw_warp_grads": "xvr_tpu/render/shearwarp.py:400",
    "sw_accumulate_adjoint": "xvr_tpu/render/shearwarp.py:955",
    "slab_forward": "xvr_tpu/render/pallas.py:92",
    "slab_backward": "xvr_tpu/render/pallas.py:485",
    "slab_channels": "xvr_tpu/render/pallas.py:324",
    "slab_siddon": "xvr_tpu/render/pallas.py:200",
    "rays_adjoint": "none (XLA's product of the rays' pose gradient)",
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
    "rays_adjoint": ("rays_adjoint_kernel", "rays_adjoint_sum_kernel"),
    "sw_content_boxes": ("sw_content_boxes_kernel",),
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


def whole_boxes(vol):
    """Content boxes of a (M, Wd, L) volume that every tile meets: K1/K4
    given them march every slab their geometry keeps (no content skip)."""
    import torch

    M, Wd, L = vol.shape
    return torch.tensor([0, Wd - 1, 0, L - 1], dtype=torch.int32, device=vol.device).repeat(M, 1)


def skip_counts(call):
    """K1/K4's slab tally over ``call()`` -> (its result, (marched, skipped
    for content))."""
    import torch
    from xvr_tpu_torch.render import _cuda

    if not torch.cuda.is_available():  # a rehearsal on the CPU: nothing counts
        return call(), (0, 0)
    tally = _cuda.slab_tally(torch.device("cuda"))
    before = tally.clone()
    out = call()
    marched, skipped = (tally - before).tolist()
    return out, (marched, skipped)


def same_as_dense(name, call, boxes, dense_boxes, label):
    """A K1/K4 call with the volume's content boxes against the same call
    with :func:`whole_boxes`, bit for bit (the skipped slabs add exactly
    +0.0), and the slab tally's counts of the two adding up. -> (the
    result, (marched, skipped))."""
    import torch

    got, (m, k) = skip_counts(lambda: call(boxes))
    dense, (md, kd) = skip_counts(lambda: call(dense_boxes))
    pairs = zip(*((x,) if torch.is_tensor(x) else x for x in (got, dense)))
    ok = all(torch.equal(a, b) for a, b in pairs) and kd == 0 and m + k == md
    log(f"  {name} {label}: content skip {k} of {m + k} slabs ({100.0 * k / max(m + k, 1):.1f}%), "
        f"bit-identical to the dense march {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {label}: the content skip changed the result or its counts "
                             f"({m}, {k}) against ({md}, {kd})")
    return got, (m, k)


def check_content_boxes(vol, label, time_ms=cuda_time_ms):
    """The content-box kernel (``sw_content_boxes``, the boxes K1/K4 skip
    by) on a permuted bf16 volume or channel stack against its plain
    version, exactly (``torch.equal``); CUDA-event time over 20 calls,
    torch.profiler device time on the card and one call of the plain
    version, beside its bound (the volume read once at HBM bandwidth).
    -> record."""
    import torch
    from xvr_tpu_torch.render import shearwarp as sw

    got, ref = sw.content_boxes(vol), sw._content_boxes(vol)
    same = bool(torch.equal(got, ref))
    C, M, Wd, L = (vol if vol.ndim == 4 else vol[None]).shape
    nbytes = vol.numel() * vol.element_size() + got.numel() * got.element_size()
    call = partial(sw.content_boxes, vol)
    rec = dict(name="sw_content_boxes", route="cuda", source=SW_SOURCE, shape=f"{label} C={C} "
               f"M={M} Wd={Wd} L={L}", same_as_plain=same, slabs=C * M,
               empty_slabs=int((got[..., 1] < 0).sum()), ms=time_ms(call, 20),
               profiler_ms=profiler_ms({"sw_content_boxes": call})["sw_content_boxes"]
               if vol.is_cuda else None,
               plain_ms=time_ms(partial(sw._content_boxes, vol), 3),
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    fmt = lambda ms: "not measured" if ms is None else f"{ms:.4f} ms"  # noqa: E731
    log(f"  sw_content_boxes [{rec['shape']}]: equal to the plain version "
        f"{'OK' if same else 'FAIL'}; {rec['empty_slabs']} of {C * M} slabs empty; kernel "
        f"{rec['ms']:.4f} ms, device {fmt(rec['profiler_ms'])}, plain {rec['plain_ms']:.4f} ms, "
        f"bound {rec['bound_ms']:.4f} ms (bytes: {nbytes / 1e6:.1f} MB)")
    if not same:
        raise AssertionError(f"sw_content_boxes {label}: the boxes differ from the plain version's")
    return rec


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
        boxes, dense = sw.content_boxes(vol)[0], whole_boxes(vol)
        for eps in (1.0, 0.25):
            kw = dict(Iu=Iu, Iv=Iv, eps=eps)
            tag = f"{label} vol {tuple(vol.shape)} grid {Iu}x{Iv} eps {eps}"
            k1 = sw.accumulate(vol, *args, boxes=boxes, **kw)
            same_as_dense("K1 sw_accumulate", lambda b: sw.accumulate(vol, *args, boxes=b, **kw),
                          boxes, dense, tag)
            same_as_dense("K4 sw_accumulate_adjoint",
                          lambda b: sw.accumulate_adjoint(vol, *args, ibar, boxes=b, **kw),
                          boxes, dense, tag)
            r1 = sw._accumulate(vol, *[a.double() for a in args], bf16=False, **kw)
            errs["sw_accumulate"] = max(errs["sw_accumulate"], check(
                "K1 sw_accumulate", k1.double(), r1, tag, 2e-5 * float(r1.abs().max()), 2e-4))
            same_bits("K1 sw_accumulate", k1,
                      lambda: sw.accumulate(vol, *args, boxes=boxes, **kw), tag)
            k4 = sw.accumulate_adjoint(vol, *args, ibar, boxes=boxes, **kw)
            r4 = sw._accumulate_adjoint(vol, *args, ibar, bf16=False, **kw)
            errs["sw_accumulate_adjoint"] = max(errs["sw_accumulate_adjoint"], check(
                "K4 sw_accumulate_adjoint", k4, r4, tag, 1e-4 * float(r4.abs().max()), 1e-3))
            same_bits("K4 sw_accumulate_adjoint", k4,
                      lambda: sw.accumulate_adjoint(vol, *args, ibar, boxes=boxes, **kw), tag)
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


def check_sw_stage(vol, proj, pose, label):
    """K1-K4 against their plain versions at one stage's shape: the inputs
    of one fast render of ``pose`` through ``proj`` on the packed volume
    ``vol``; K1 and K4 at eps 1.0 and 0.25, K2 and K3 on K1's eps-1.0 image,
    each held bit for bit over REPEATS more calls (tolerances: see
    :func:`phase_kernels`). -> (inputs, K1's image and K4's cotangent image
    at eps 1.0, {kernel: max abs error}, tag)."""
    from xvr_tpu_torch.render import _cuda
    from xvr_tpu_torch.render import shearwarp as sw

    det = (proj.detector.height, proj.detector.width)
    x = path_inputs(proj, pose, seed=1)
    Iu, Iv = x["grid"]
    B, R = x["uc"].shape
    args = (x["s"], x["sgn"], x["u0"], x["du"], x["v0"], x["dv"])
    boxes, dense = sw.content_boxes(vol)[0], whole_boxes(vol)
    errs, out = {}, None
    for eps in (1.0, 0.25):
        tag = f"{label} det {det[0]}x{det[1]} grid {Iu}x{Iv} eps {eps}"
        kw = dict(Iu=Iu, Iv=Iv, eps=eps)

        def k1_call(b):
            return sw.accumulate(vol, *args, boxes=b, **kw)

        k1, _ = same_as_dense("K1 sw_accumulate", k1_call, boxes, dense, tag)
        r1 = sw._accumulate(vol, *(a.double() for a in args), bf16=False, **kw)
        e1 = check("K1 sw_accumulate", k1.double(), r1, tag, 2e-5 * float(r1.abs().max()), 2e-4)
        same_bits("K1 sw_accumulate", k1, partial(k1_call, boxes), tag)
        log(f"    vs JAX bf16 recipe: {float((k1 - sw._accumulate(vol, *args, **kw)).abs().max()):.3e}")
        # K4 on the cotangent image of a random detector cotangent
        ibar = sw._warp_transpose(x["g"] * x["ws"], x["uc"], x["vc"], grid_shape=(Iu, Iv))

        def k4_call(b):
            return sw.accumulate_adjoint(vol, *args, ibar, boxes=b, **kw)

        k4, _ = same_as_dense("K4 sw_accumulate_adjoint", k4_call, boxes, dense, tag)
        r4 = sw._accumulate_adjoint(vol, *args, ibar, bf16=False, **kw)
        e4 = check("K4 sw_accumulate_adjoint", k4, r4, tag, 1e-4 * float(r4.abs().max()), 1e-3)
        same_bits("K4 sw_accumulate_adjoint", k4, partial(k4_call, boxes), tag)
        log(f"    vs JAX bf16 recipe: {float((k4 - sw._accumulate_adjoint(vol, *args, ibar, **kw)).abs().max()):.3e}")
        errs["sw_accumulate"] = max(errs.get("sw_accumulate", 0.0), e1)
        errs["sw_accumulate_adjoint"] = max(errs.get("sw_accumulate_adjoint", 0.0), e4)
        if eps != 1.0:
            continue
        for name, grads in (("K2", False), ("K3", True)):
            threads, pix = _cuda.warp_plan(B, R, grads, _cuda.sm_count(k1.device))
            log(f"  {name} {tag}: plan {threads} threads x {pix} pixels per thread, "
                f"{-(-B * R // (threads * pix))} blocks")
        errs["sw_warp"], errs["sw_warp_grads"] = check_warps(k1, x["uc"], x["vc"], x["ws"], tag)
        out = (x, k1, ibar, tag)
    x, k1, ibar, tag = out
    return x, k1, ibar, errs, tag


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
    boxes = sw.content_boxes(vol)[0]  # made once, as the render's operand carries them
    M, Wd, L = vol.shape
    records, calls = {}, []
    cases = stage_cases(projector, pose16, pose4)

    for label, pose, scale in cases:
        proj = projector.rescale_detector(scale)
        det = (proj.detector.height, proj.detector.width)
        x, k1, ibar, errs, tag = check_sw_stage(vol, proj, pose, label)
        eps = 1.0  # the times' and the warps' image
        Iu, Iv = x["grid"]
        B, R = x["uc"].shape
        args = (x["s"], x["sgn"], x["u0"], x["du"], x["v0"], x["dv"])
        warp_args = (x["uc"], x["vc"], x["ws"])

        # times at this shape (eps 1.0)
        reps = 20
        # library yardstick for the warps: grid_sample on the same image
        gx = (x["vc"] / (Iv - 1)) * 2 - 1
        gy = (x["uc"] / (Iu - 1)) * 2 - 1
        grid_n = torch.stack([gx, gy], -1).reshape(B, 1, R, 2)
        img = k1[:, None]
        grid_sample = partial(F.grid_sample, img, grid_n, mode="bilinear", align_corners=True)
        calls.append(dict(  # bound now: the loop variables move on
            sw_accumulate=partial(sw.accumulate, vol, *args, Iu=Iu, Iv=Iv, eps=eps, boxes=boxes),
            sw_accumulate_adjoint=partial(sw.accumulate_adjoint, vol, *args, ibar, Iu=Iu,
                                          Iv=Iv, eps=eps, boxes=boxes),
            sw_warp=partial(sw.warp, k1, *warp_args),
            sw_warp_grads=partial(sw.warp_with_grads, k1, *warp_args),
            grid_sample=grid_sample,
        ))
        t = {
            "sw_accumulate": (
                time_ms(lambda: sw.accumulate(vol, *args, Iu=Iu, Iv=Iv, eps=eps, boxes=boxes), reps),
                time_ms(lambda: sw._accumulate(vol, *args, Iu=Iu, Iv=Iv, eps=eps), 3),
                None,
            ),
            "sw_accumulate_adjoint": (
                time_ms(lambda: sw.accumulate_adjoint(vol, *args, ibar, Iu=Iu, Iv=Iv, eps=eps,
                                                      boxes=boxes), reps),
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
        bounds = {name: sw_bounds(name, (M, Wd, L), x, B, R, Iu, Iv) for name in t}
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


def rays_cotangent(proj, pose, seed: int):
    """The rays' cotangent as the registrar's backward hands it to the pose:
    one fast render of ``pose`` through ``proj`` (a pyramid stage's
    projector) under a random image cotangent, back to its ray targets.
    -> (g (B, R, 3), the detector's shared points q (R, 3))."""
    import torch

    src, tgt = proj.rays(pose)
    tgt = tgt.detach().requires_grad_(True)
    img = proj.render_rays(src.detach(), tgt)
    gen = torch.Generator(device=img.device).manual_seed(seed)
    w = torch.randn(img.shape, generator=gen, device=img.device)
    (g,) = torch.autograd.grad((img * w).sum(), tgt)
    return g.contiguous(), proj.detector._target_grid(g.dtype, g.device)


def phase_rays_adjoint(projector, pose16, pose4, time_ms=cuda_time_ms):
    """``rays_adjoint`` at the shapes of :func:`stage_cases` against its
    plain version in float64 of the same float32 inputs, to 1e-6 of each
    pose's largest entry (its double sums round once, to float32); REPEATS
    more calls bit-identical; CUDA-event times of the kernel, of its plain
    version and of the batched GEMM autograd ran in its place (library),
    beside its bound: B R 3 + R 3 floats read, 21 float64 operations per
    (ray, pose). Nothing here runs the profiler: profiling this early makes a
    later profile lose K1's records (main's loop profiles the kernel).
    -> (records, one dict of calls per shape for the profiler)."""
    import torch
    from xvr_tpu_torch.geometry.se3 import _shared_adjoint_plain
    from xvr_tpu_torch.render import _cuda

    name, records, calls = "rays_adjoint", [], []
    for label, pose, scale in stage_cases(projector, pose16, pose4):
        proj = projector.rescale_detector(scale)
        det = (proj.detector.height, proj.detector.width)
        g, q = rays_cotangent(proj, pose, seed=1)
        B, R, _ = g.shape
        tag = f"{label} det {det[0]}x{det[1]}"
        got = _cuda.rays_adjoint(g, q)
        ref = _shared_adjoint_plain(g.double(), q.double())
        per_pose = ref.abs().amax(dim=(-1, -2), keepdim=True)
        err = check(name, got.double() / per_pose, ref / per_pose, tag, 1e-6)
        same_bits(name, got, lambda: _cuda.rays_adjoint(g, q), tag)
        gemm = partial(torch.bmm, q.expand(B, R, 3).transpose(1, 2), g)
        calls.append({name: partial(_cuda.rays_adjoint, g, q)})
        ms = time_ms(lambda: _cuda.rays_adjoint(g, q), 20)
        plain_ms = time_ms(lambda: _shared_adjoint_plain(g, q), 20)
        lib_ms = time_ms(gemm, 20)
        nbytes, nops = (B * R * 3 + R * 3 + B * 16) * 4, 21 * B * R
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / F64_FLOPS * 1e3
        rec = dict(name=name, route="cuda", source=RAYS_SOURCE, replaces=REPLACES[name],
                   launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   library_ms=lib_ms, shape=f"B={B} det={det[0]}x{det[1]}", B=B, det=det[0])
        log(f"  time {name} [{rec['shape']}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library (bmm [B, 3, R] x [B, R, 3]) {lib_ms:.4f} ms, "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: {nbytes / 1e6:.2f} MB, "
            f"{nops / 1e6:.1f} M float64 operations)")
        records.append(rec)
    _cuda.reset_launches()
    return {name: records}, calls


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


# K1-K4 at the trainer's shape: the finetune configuration's poses (batch 116
# at 128^2, alpha 135-225, beta +-45), rendered by the shear-warp projector
# the trainer chooses for them, unmasked and as the two-label stack
FINETUNE_RANGES = dict(alphamin=135.0, alphamax=225.0, betamin=-45.0, betamax=45.0,
                       gammamin=-15.0, gammamax=15.0, txmin=-150.0, txmax=150.0,
                       tymin=450.0, tymax=1000.0, tzmin=-150.0, tzmax=150.0)
TRAIN_LABELS = (1, 2)


def train_mask(n: int):
    """The trainer's two-label mask (scripts/bench_train.py's construction):
    two adjacent boxes in the middle of an n^3 volume, int32."""
    import numpy as np

    mask = np.zeros((n, n, n), dtype=np.int32)
    mask[n // 4 : n // 2, n // 4 : 3 * n // 4, n // 4 : 3 * n // 4] = 1
    mask[n // 2 : 3 * n // 4, n // 4 : 3 * n // 4, n // 4 : 3 * n // 4] = 2
    return mask


def sw_trainer_inputs(hu, aff, dev="cuda", seed=4):
    """The masked projector the trainer picks for the finetune ranges (one
    stratum, its permutation and label slab bounds) and TRAINER["B"] poses
    drawn as the trainer draws them (seeded generator, shifted to the volume
    centre). -> (projector with labels, poses)."""
    import torch
    from xvr_tpu_torch.geometry import RigidTransform, make_translation
    from xvr_tpu_torch.render import Projector, Volume
    from xvr_tpu_torch.train.sampler import get_random_pose
    from xvr_tpu_torch.train.trainer import Trainer

    vol = Volume(torch.as_tensor(hu, device=dev), torch.as_tensor(aff, device=dev),
                 mask=torch.as_tensor(train_mask(hu.shape[0]), device=dev))
    r = FINETUNE_RANGES
    proj = Projector.from_volume(vol, sdd=TRAINER["sdd"], height=TRAINER["height"],
                                 delx=TRAINER["delx"], labels=TRAIN_LABELS)
    proj = proj.with_shearwarp(Trainer._mean_pose((r["alphamin"] + r["alphamax"]) / 2, r),
                               probe_poses=Trainer._probe_corners(**r))
    if proj.renderer != "trilinear_fast":
        raise AssertionError(f"shear-warp declined the finetune ranges: {proj.renderer}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    pose = get_random_pose(gen, batch_size=TRAINER["B"], **r)
    return proj, RigidTransform(pose.compose(make_translation(vol.center)).matrix)


def sw_bounds(name, vol_shape, x, B, R, Iu, Iv, k0=0, k1=None):
    """(bytes, f32 operations) of one K1-K4 call on ``x`` (path_inputs)
    over the slab range [k0, k1): each input read and each output written
    once; K1 8 and K4 16 operations per active sample, K2 12 and K3 16 per
    pixel."""
    M, Wd, L = vol_shape
    k1 = M if k1 is None else k1
    vol_b = (k1 - k0) * Wd * L * 2
    if name == "sw_accumulate":
        return vol_b + B * 8 * 4 + B * Iu * Iv * 4, 8 * active_samples(vol_shape, x, k0, k1)
    if name == "sw_accumulate_adjoint":
        return (vol_b + B * Iu * Iv * 2 + B * 8 * 4 + B * (Iu + Iv) * 4,
                16 * active_samples(vol_shape, x, k0, k1))
    if name == "sw_warp":
        return B * Iu * Iv * 4 + 4 * B * R * 4, 12 * B * R
    return B * Iu * Iv * 4 + 6 * B * R * 4, 16 * B * R


def phase_trainer_shearwarp(hu, aff, dev="cuda", time_ms=cuda_time_ms):
    """K1-K4 at the trainer's shape (TRAINER["B"] poses at 128^2 on the
    256^3 CT): single-channel, and as the masked stack with its label slab
    bounds (K1/K4 once per channel, K2/K3 over the C·B fold). Held against
    their plain versions with bf16=False (phase_kernels' tolerances) on the
    first TRAINER_CHECKED images of each channel, eleven calls bit-identical,
    timed by CUDA events (beside one call of the plain version on all images)
    and, on the card, torch.profiler device time, each with its bound; the
    stack's content boxes against their plain version (:func:`check_content_boxes`).
    -> name -> {"single": record, "masked": record} (``sw_content_boxes``:
    "masked" alone)."""
    import torch
    from xvr_tpu_torch.render import _cuda
    from xvr_tpu_torch.render import shearwarp as sw

    proj, pose = sw_trainer_inputs(hu, aff, dev=dev)
    x = path_inputs(proj, pose, seed=3)
    Iu, Iv = x["grid"]
    B, R = x["uc"].shape
    n = TRAINER_CHECKED
    stack = proj.prepare_for_shearwarp()  # (C, M, Wd, L): the full density, then the labels
    boxes, dense = sw.content_boxes(stack), whole_boxes(stack[0])
    bounds = proj.shearwarp_bounds
    vol_shape = tuple(stack.shape[1:])
    args = (x["s"], x["sgn"], x["u0"], x["du"], x["v0"], x["dv"])
    head64 = tuple(a[:n].double() for a in args)
    head = tuple(a[:n] for a in args)
    kw = dict(Iu=Iu, Iv=Iv, eps=1.0)
    ibar = sw._warp_transpose(x["g"] * x["ws"], x["uc"], x["vc"], grid_shape=(Iu, Iv))
    det = TRAINER["height"]
    fmt = lambda ms: "not measured" if ms is None else f"{ms:.4f} ms"  # noqa: E731
    log(f"  trainer shear-warp: perm {proj.pallas_perm}, label slab bounds {bounds}, grid "
        f"{Iu}x{Iv}, B={B}, R={R}")

    def acc(c, *a, boxes_c=None):
        return sw.accumulate(stack[c], *a, k0=bounds[c][0], k1=bounds[c][1],
                             boxes=boxes[c] if boxes_c is None else boxes_c, **kw)

    def adj(c, *a, boxes_c=None):
        return sw.accumulate_adjoint(stack[c], *a, k0=bounds[c][0], k1=bounds[c][1],
                                     boxes=boxes[c] if boxes_c is None else boxes_c, **kw)

    out = {"sw_content_boxes": {"masked": check_content_boxes(stack, "trainer stack",
                                                             time_ms=time_ms)}}
    for variant, chans in (("single", [0]), ("masked", list(range(stack.shape[0])))):
        C = len(chans)
        tag = f"trainer {variant} B={B} det {det}^2 grid {Iu}x{Iv}"
        errs = dict.fromkeys(SW_KERNELS, 0.0)
        I = torch.stack([acc(c, *args) for c in chans])
        for c in chans:
            k0, k1 = bounds[c]
            r1 = sw._accumulate(stack[c], *head64, bf16=False, k0=k0, k1=k1, **kw)
            errs["sw_accumulate"] = max(errs["sw_accumulate"], check(
                "K1 sw_accumulate", I[c, :n].double(), r1, f"{tag} channel {c} slabs [{k0},{k1})",
                2e-5 * float(r1.abs().max()), 2e-4))
            same_bits("K1 sw_accumulate", I[c], partial(acc, c, *args), f"{tag} channel {c}")
            k4 = adj(c, *args, ibar)
            r4 = sw._accumulate_adjoint(stack[c], *head, ibar[:n], bf16=False, k0=k0, k1=k1, **kw)
            errs["sw_accumulate_adjoint"] = max(errs["sw_accumulate_adjoint"], check(
                "K4 sw_accumulate_adjoint", k4[:n], r4, f"{tag} channel {c} slabs [{k0},{k1})",
                1e-4 * float(r4.abs().max()), 1e-3))
            same_bits("K4 sw_accumulate_adjoint", k4, partial(adj, c, *args, ibar),
                      f"{tag} channel {c}")
            same_as_dense("K1 sw_accumulate", lambda b: acc(c, *args, boxes_c=b), boxes[c],
                          dense, f"{tag} channel {c}")
            same_as_dense("K4 sw_accumulate_adjoint", lambda b: adj(c, *args, ibar, boxes_c=b),
                          boxes[c], dense, f"{tag} channel {c}")
        # K2/K3 over the fold of the channels, as the render launches them
        If = I.reshape(C * B, Iu, Iv)
        ucf, vcf, wsf = (a.repeat(C, 1).contiguous() for a in (x["uc"], x["vc"], x["ws"]))
        k2 = sw.warp(If, ucf, vcf, wsf)
        k3 = torch.stack(sw.warp_with_grads(If, ucf, vcf, wsf))
        for c in chans:
            rows = slice(c * B, c * B + n)
            w64 = [a[rows].double() for a in (ucf, vcf, wsf)]
            r2 = sw._warp_plain(If[rows].double(), *w64, bf16=False)
            errs["sw_warp"] = max(errs["sw_warp"], check(
                "K2 sw_warp", k2[rows].double(), r2, f"{tag} fold rows of channel {c}",
                1e-5 * float(r2.abs().max())))
            r3 = sw._warp_with_grads_plain(If[rows].double(), *w64, bf16=False)
            scale = 1e-5 * float(If[rows].abs().max())
            for o in range(3):
                errs["sw_warp_grads"] = max(errs["sw_warp_grads"], check(
                    f"K3 sw_warp_grads[{o}]", k3[o][rows].double(), r3[o],
                    f"{tag} fold rows of channel {c}", scale))
        same_bits("K2 sw_warp", k2, partial(sw.warp, If, ucf, vcf, wsf), tag)
        same_bits("K3 sw_warp_grads", k3, lambda: torch.stack(sw.warp_with_grads(If, ucf, vcf, wsf)),
                  tag)
        calls = {
            "sw_accumulate": (lambda: [acc(c, *args) for c in chans],
                              lambda: [sw._accumulate(stack[c], *args, k0=bounds[c][0],
                                                      k1=bounds[c][1], **kw) for c in chans]),
            "sw_warp": (partial(sw.warp, If, ucf, vcf, wsf),
                        partial(sw._warp_plain, If, ucf, vcf, wsf)),
            "sw_warp_grads": (partial(sw.warp_with_grads, If, ucf, vcf, wsf),
                              partial(sw._warp_with_grads_plain, If, ucf, vcf, wsf)),
            "sw_accumulate_adjoint": (
                lambda: [adj(c, *args, ibar) for c in chans],
                lambda: [sw._accumulate_adjoint(stack[c], *args, ibar, k0=bounds[c][0],
                                                k1=bounds[c][1], **kw) for c in chans]),
        }
        # K1/K4 marching every slab their geometry keeps, beside
        dense_calls = {
            "sw_accumulate": lambda: [acc(c, *args, boxes_c=dense) for c in chans],
            "sw_accumulate_adjoint": lambda: [adj(c, *args, ibar, boxes_c=dense) for c in chans],
        }
        prof = (profiler_ms({k: v[0] for k, v in calls.items()}) if dev == "cuda"
                else dict.fromkeys(calls))
        dprof = profiler_ms(dense_calls) if dev == "cuda" else dict.fromkeys(dense_calls)
        for name, (call, plain) in calls.items():
            per_channel = name in ("sw_accumulate", "sw_accumulate_adjoint")
            nbytes = nops = 0
            for c in chans if per_channel else [0]:
                b, o = sw_bounds(name, vol_shape, x, B if per_channel else C * B, R, Iu, Iv,
                                 *(bounds[c] if per_channel else (0, vol_shape[0])))
                nbytes, nops = nbytes + b, nops + o
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_FLOPS * 1e3
            rec = dict(shape=f"B={B} det={det}^2 grid={Iu}x{Iv} {variant} C={C}"
                             + (f" ({C} launches per call)" if per_channel and C > 1 else
                                f" (fold of {C * B} images)" if C > 1 else ""),
                       ms=time_ms(call, 20), plain_ms=time_ms(plain, 1, warmup=0),
                       profiler_ms=prof[name], bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       max_abs_err=errs[name], launches_per_call=C if per_channel else 1)
            if name in dense_calls:
                rec.update(dense_ms=time_ms(dense_calls[name], 20), dense_profiler_ms=dprof[name])
                log(f"  time {name} [{rec['shape']}] marching every slab: kernel "
                    f"{rec['dense_ms']:.4f} ms, device {fmt(rec['dense_profiler_ms'])}")
            log(f"  time {name} [{rec['shape']}]: kernel {rec['ms']:.4f} ms, device "
                f"{fmt(rec['profiler_ms'])}, plain {rec['plain_ms']:.4f} ms, bound "
                f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}: {nbytes / 1e6:.1f} MB, "
                f"{nops / 1e9:.3f} GFLOP)")
            out.setdefault(name, {})[variant] = rec
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


def bench_registrar(workdir: Path, gt_pose, n_itrs="500,500,500", dev="cuda", **kw):
    """The bench's registrar (scripts/bench_register.py:398-413) for the
    scene's X-ray, from the ~4 mm init about ``gt_pose``."""
    import numpy as np
    from xvr_tpu_torch.registrar import RegistrarFixed

    rot0, xyz0 = gt_pose.convert("euler_angles", "ZXY")
    rot_init = (rot0[0].cpu().numpy() + np.deg2rad([0.6, -0.5, 0.4])).tolist()
    xyz_init = (xyz0[0].cpu().numpy() + np.array([2.0, -3.0, 1.5])).tolist()
    cfg = dict(volume=workdir / "ct.nii.gz", mask=None, orientation="AP", rot=rot_init,
               xyz=xyz_init, linearize=False, scales="24,12,6", n_itrs=n_itrs, crop=100,
               reverse_x_axis=False, lr_rot=1e-2, lr_xyz=1.0, patience=10, max_n_plateaus=3,
               verbose=1, coarse_seeds=16, device=dev)
    return RegistrarFixed(**{**cfg, **kw})


def register(workdir: Path, gt_pose, fids, renderer, kernels, no_shearwarp=False, dev="cuda",
             n_itrs="500,500,500"):
    """Register the scene's X-ray with the bench's configuration from the
    ~4 mm init, with the launch counts of this run alone. Checks the
    renderer, that ``kernels`` launched and the others did not, and mTRE
    < 1 mm. -> (launches, stats)."""
    gt_np = gt_pose.matrix[0].cpu().numpy()
    saved = os.environ.pop("XVR_NO_SHEARWARP", None)
    if no_shearwarp:
        os.environ["XVR_NO_SHEARWARP"] = "1"
    try:
        reg = bench_registrar(workdir, gt_pose, n_itrs, dev)
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


# ---------------------------------------------------------------------------
# phase 5: the entry points (python -m xvr_tpu_torch.cli register ...)
# ---------------------------------------------------------------------------

# the CNN users run (scripts/deepfluoro/train/*.sh: resnet34, GroupNorm) at
# the trainer's operating point (128^2, delx 2.1764375, sdd 1020)
MODEL_CONFIG = dict(model_name="resnet34", norm_layer="groupnorm",
                    parameterization="quaternion_adjugate", convention="ZXY",
                    unit_conversion_factor=1000.0, height=128, delx=2.1764375, sdd=1020.0,
                    orientation="AP")
# phase 4's registration, through the CLI (the rest are the CLI's defaults;
# every command also takes phase 4's --crop 100)
CLI_REGISTER = ["--scales", "24,12,6", "--n_itrs", "500,500,500", "--coarse_seeds", "16"]
CLI_RESTART = ["--scales", "6", "--n_itrs", "100"]
# CNN features on the card against the same module on the CPU, as a share of
# max |feature|: cuDNN's TF32 convolutions (10-bit mantissa, rounding 2^-11
# per product, through 36 convolutions) and, with TF32 off, float32 sums in
# another order (the bound of the CPU parity with the JAX package)
CNN_TF32_RTOL = 1e-2
CNN_FP32_RTOL = 1e-4


def synthetic_checkpoint(path, gt_pose, xray, crop=0, config=MODEL_CONFIG, seed=0,
                         rot_off_deg=(0.4, -0.3, 0.3), xyz_off_mm=(1.5, -2.0, 1.0),
                         head_step=(1e-3, 1.5), device="cuda", linearize=False):
    """Write a checkpoint (the JAX layout, no trained weights) of a
    PoseRegressor whose prediction on ``xray`` lies a few mm off ``gt_pose``.
    The backbone takes flax's initialization from a seeded torch.Generator;
    the head biases encode ``gt_pose`` moved by ``rot_off_deg`` (ZXY degrees)
    and ``xyz_off_mm``; the head kernels are random and scaled so that on
    this X-ray's features they add a step of norm ``head_step[0]`` to the
    rotation parameters and of ``head_step[1]`` mm to the translation.
    ``xray`` may be a list of N X-rays with N poses in ``gt_pose``: each head
    kernel then also gets the least-norm term that is zero on the first
    X-ray's features and moves the prediction on the i-th from the first
    one's target to its own. ``linearize`` reads the X-rays as ``register
    --linearize`` does. -> (model on ``device``, its input: the first
    preprocessed X-ray)."""
    import numpy as np
    import torch
    from xvr_tpu_torch.geometry import convert
    from xvr_tpu_torch.io import read_xray
    from xvr_tpu_torch.models import PoseRegressor, init_pose_regressor
    from xvr_tpu_torch.models.inference import predict_pose
    from xvr_tpu_torch.state import to_flax_params
    from xvr_tpu_torch.train import save_checkpoint

    gen = torch.Generator().manual_seed(seed)
    model = PoseRegressor(config["model_name"], config["parameterization"], config["convention"],
                          config["norm_layer"], config["unit_conversion_factor"])
    model = init_pose_regressor(model, gen).to(device).eval()
    inputs = []
    for path_i in xray if isinstance(xray, (list, tuple)) else [xray]:
        gt, sdd, delx, dely, x0, y0, _ = read_xray(path_i, crop, False, linearize)
        inputs.append(predict_pose(model, dict(model.state_dict()), config, gt, sdd, delx, dely,
                                   x0, y0)[1])
    x = inputs[0]
    rot, xyz = gt_pose.convert("euler_angles", "ZXY")
    off = torch.tensor(np.deg2rad(rot_off_deg), dtype=torch.float32, device=rot.device)
    target = convert(rot + off, xyz + torch.tensor(xyz_off_mm, device=xyz.device),
                     "euler_angles", "ZXY")
    t_rot, t_xyz = target.convert(config["parameterization"], config["convention"])
    ucf = config["unit_conversion_factor"]
    with torch.no_grad():
        feats = model.backbone(x)[0]
        for head, step, bias in ((model.rot_head, head_step[0], t_rot[0]),
                                 (model.xyz_head, head_step[1] / ucf, t_xyz[0] / ucf)):
            w = torch.randn(head.weight.shape, generator=gen).to(device)
            head.weight.copy_(w * (step / float(torch.linalg.norm(w @ feats))))
            head.bias.copy_(bias.to(device))
        if len(inputs) > 1:
            F = torch.stack([model.backbone(x_i)[0] for x_i in inputs]).double().cpu()
            for head, t in ((model.rot_head, t_rot), (model.xyz_head, t_xyz / ucf)):
                D = (t - t[0]).double().cpu().T  # (d, N); its first column is 0
                head.weight.add_((D @ torch.linalg.pinv(F.T)).float().to(device))
    save_checkpoint(path, to_flax_params(model), {}, 0, 0, config)
    return model, x


def cnn_forward_check(model, x, time_ms=cuda_time_ms):
    """The CNN's forward on the card against the same module on the CPU,
    with cuDNN's TF32 as the path runs it and with TF32 off; its time (CUDA
    events, batch 1) beside the device time of its kernels (torch.profiler).
    -> stats."""
    import copy

    import torch

    cpu = copy.deepcopy(model).cpu()
    with torch.no_grad():
        ref = cpu.backbone(x.cpu())
        feats = model.backbone(x).cpu()
        tf32 = bool(torch.backends.cudnn.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        try:
            feats32 = model.backbone(x).cpu()
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        scale = float(ref.abs().max())
        err, err32 = (float((f - ref).abs().max()) / scale for f in (feats, feats32))
        ms = time_ms(lambda: model(x), 20)
        device_ms, names = library_device_ms(lambda: model(x))
    log(f"entry: CNN {MODEL_CONFIG['model_name']} on {tuple(x.shape)}: card vs CPU features "
        f"max err {err:.3e} of max |feature| {scale:.3f} (<= {CNN_TF32_RTOL}; cuDNN TF32 "
        f"{'on' if tf32 else 'off'}), with TF32 off {err32:.3e} (<= {CNN_FP32_RTOL}); "
        f"forward {ms:.4f} ms (CUDA events, 20 calls, batch 1), device time "
        f"{'not measured' if device_ms is None else f'{device_ms:.4f} ms'} over "
        f"{len(names)} kernel names (torch.profiler, 10 calls)")
    if not (err <= CNN_TF32_RTOL and err32 <= CNN_FP32_RTOL):
        raise AssertionError("the CNN's forward on the card disagrees with the CPU")
    return dict(tf32=tf32, feature_err=err, feature_err_no_tf32=err32, forward_ms=ms,
                forward_device_ms=device_ms, kernel_names=len(names))


class saved_registrars:
    """Within the block, every registrar whose result bundle is written is
    kept in ``self.seen`` (the CLI builds and drops its own)."""

    def __enter__(self):
        from xvr_tpu_torch.registrar.base import RegistrarBase

        self.seen, self.orig = [], RegistrarBase._save_result

        def spy(reg, *a, **k):
            self.seen.append(reg)
            return self.orig(reg, *a, **k)

        RegistrarBase._save_result = spy
        return self

    def __exit__(self, *exc):
        from xvr_tpu_torch.registrar.base import RegistrarBase

        RegistrarBase._save_result = self.orig


def cli_run(name, argv, kernels, renderer=None, bundles=1):
    """Run ``python -m xvr_tpu_torch.cli`` in process with the launch counts
    of this run alone; checks ``kernels`` launched and no other, that one
    registrar wrote ``bundles`` result bundles, and its renderer.
    -> (registrar, launches, wall s)."""
    from xvr_tpu_torch.cli import main

    with saved_registrars() as saved:
        t0 = time.perf_counter()
        _, launches = counted(kernels, lambda: main(argv))
        wall = time.perf_counter() - t0
    if len(saved.seen) != bundles or len(set(map(id, saved.seen))) != 1:
        raise AssertionError(f"{name}: {len(saved.seen)} bundles written, not {bundles} by one "
                             f"registrar")
    reg = saved.seen[0]
    stray = [k for k, v in launches.items() if v and k not in kernels]
    log(f"entry: {name}: renderer {reg.projector.renderer}, wall {wall:.2f} s, "
        f"launches {json.dumps(launches)}")
    for rec in reg.stage_log:
        log(f"  stage {rec['stage']} K={rec['K']} {rec['height']}x{rec['width']} "
            f"{rec['renderer']}: {rec['n_done']} itrs, {rec['ms_per_itr']:.2f} ms/itr")
    if stray:
        raise AssertionError(f"{name}: kernels of another path launched: {stray}")
    if renderer is not None and reg.projector.renderer != renderer:
        raise AssertionError(f"{name} ran {reg.projector.renderer}, not {renderer}")
    return reg, launches, wall


def phase_entry_points(workdir: Path, gt_pose, fids, card: str, dev="cuda", kernels=None,
                       register_args=CLI_REGISTER, restart_args=CLI_RESTART, crop=100,
                       config=MODEL_CONFIG, time_ms=cuda_time_ms):
    """``register model`` from a synthetic ResNet-34 checkpoint, ``register
    restart`` from its bundle and ``register dicom --init_only`` from the
    X-ray's positioner tags, through the CLI in the scene directory. Times
    are tagged with ``card`` (nvidia-smi's name and power limit).
    -> (launches of ``register model``, stats)."""
    import numpy as np
    import torch
    from xvr_tpu_torch.io import dcmread, dcmwrite, parse_dicom_pose, pixel_array, read_xray
    from xvr_tpu_torch.models.inference import predict_pose

    kernels = REGISTER_SW if kernels is None else kernels
    xray, ct = workdir / "xray.dcm", str(workdir / "ct.nii.gz")
    gt_np = gt_pose.matrix[0].cpu().numpy()
    base = ["-v", ct, "--device", dev, "--crop", str(crop)]
    stats = {}

    # 1. the checkpoint, and the CNN's forward on the card against the CPU
    ckpt = workdir / "model" / f"{config['model_name']}.ckpt"
    model, x = synthetic_checkpoint(ckpt, gt_pose, xray, crop, config, device=dev)
    if dev == "cuda":
        stats["cnn"] = cnn_forward_check(model, x, time_ms)
    gt, sdd, delx, dely, x0, y0, _ = read_xray(xray, crop, False, False)
    pred = predict_pose(model, dict(model.state_dict()), config, gt, sdd, delx, dely, x0, y0)[0]
    m_cnn = fiducial_mtre(pred.matrix.cpu().numpy(), gt_np, fids)
    log(f"entry: checkpoint {ckpt.name} ({ckpt.stat().st_size / 2**20:.1f} MiB): the CNN's "
        f"pose is {m_cnn:.3f} mm mTRE from the GT (1-10 mm)")
    if not 1.0 <= m_cnn <= 10.0:
        raise AssertionError(f"the synthetic CNN's init is {m_cnn:.3f} mm off, not 1-10 mm")

    # 2. register model
    out = workdir / "out_model"
    reg, launches, wall = cli_run(
        "register model", ["register", "model", str(xray), *base, "-c", str(ckpt), "-o", str(out),
                           *register_args], kernels, renderer="trilinear_fast" if kernels else None)
    bundle = np.load(out / "xray" / "parameters.npz")
    meta = json.loads((out / "xray" / "parameters.json").read_text())
    pred_np = pred.matrix.cpu().numpy()
    init_tol = 1e-6 * float(np.abs(pred_np).max())  # a few float32 ulps
    init_err = float(np.abs(bundle["init_pose"] - pred_np).max())
    m_init = fiducial_mtre(bundle["init_pose"], gt_np, fids)
    m_final = fiducial_mtre(bundle["final_pose"], gt_np, fids)
    log(f"entry: register model: bundle init pose vs predict_pose max |diff| {init_err:.3e} "
        f"(<= {init_tol:.3e}); mTRE {m_init:.3f} -> {m_final:.3f} mm (< 1 mm); type "
        f"{meta.get('type')}, date {meta.get('date')}")
    if init_err > init_tol:
        raise AssertionError("register model's init pose is not the CNN's prediction")
    if not (meta.get("type") == "model" and meta.get("ckptpath") == str(ckpt) and meta.get("date")):
        raise AssertionError(f"register model's bundle lacks type/ckptpath/date: {meta}")
    if not m_final < 1.0:
        raise AssertionError(f"register model: final mTRE {m_final:.3f} mm >= 1 mm")
    stats["model"] = dict(wall_s=wall, mtre_cnn_mm=m_cnn, mtre_final_mm=m_final,
                          stages=[dict(stage=r["stage"], K=r["K"], det=r["height"],
                                       n_done=r["n_done"], ms_per_itr=r["ms_per_itr"])
                                  for r in reg.stage_log])
    model_launches = launches

    # 3. register restart from that bundle
    out_r = workdir / "out_restart"
    _, _, wall = cli_run(
        "register restart", ["register", "restart", str(xray), *base, "-o", str(out_r), "--ckpt",
                             str(out / "xray" / "parameters.npz"), *restart_args],
        kernels, renderer="trilinear_fast" if kernels else None)
    rb = np.load(out_r / "xray" / "parameters.npz")
    m_restart = fiducial_mtre(rb["final_pose"], gt_np, fids)
    same = bool(np.array_equal(rb["init_pose"], bundle["final_pose"]))
    log(f"entry: register restart: init pose = the model run's final pose bit for bit: {same}; "
        f"mTRE {m_final:.3f} -> {m_restart:.3f} mm (< 1 mm)")
    if not same or not m_restart < 1.0:
        raise AssertionError("register restart: init pose not the bundle's, or mTRE >= 1 mm")
    stats["restart"] = dict(wall_s=wall, mtre_final_mm=m_restart)

    # 4. register dicom --init_only, from the positioner tags
    pos = workdir / "positioner" / "xray.dcm"
    pos.parent.mkdir(exist_ok=True)
    ds = dcmread(xray)
    spacing = [float(v) for v in ds.PixelSpacing]
    dcmwrite(pos, pixel_array(ds), sdd=float(ds.DistanceSourceToDetector),
             row_spacing=spacing[0], col_spacing=spacing[1],
             extra=[(0x0018, 0x1510, b"DS", "181.5"), (0x0018, 0x1511, b"DS", "-3.5"),
                    (0x0018, 0x1111, b"DS", "745")])
    out_d = workdir / "out_dicom"
    _, _, wall = cli_run("register dicom", ["register", "dicom", str(pos), *base, "-o", str(out_d),
                                            "--init_only"], ())
    db = np.load(out_d / "xray" / "parameters.npz")
    ref = parse_dicom_pose(pos, "AP", device=dev).matrix.cpu().numpy()
    same = bool(np.array_equal(db["init_pose"].reshape(ref.shape), ref))
    log(f"entry: register dicom --init_only: init pose = parse_dicom_pose bit for bit: {same}; "
        f"final pose saved: {'final_pose' in db.files}")
    if not same or "final_pose" in db.files:
        raise AssertionError("register dicom: init pose is not the positioner's")
    stats["dicom"] = dict(wall_s=wall)
    cnn_ms = stats["cnn"]["forward_ms"] if "cnn" in stats else None
    log(f"entry: wall register model {stats['model']['wall_s']:.2f} s, register restart "
        f"{stats['restart']['wall_s']:.2f} s, register dicom --init_only {wall:.2f} s; CNN "
        f"forward {'not measured' if cnn_ms is None else f'{cnn_ms:.4f} ms'} (batch 1, "
        f"{config['height']}^2) [{card}]")
    return model_launches, stats


SW_KERNELS = ("sw_accumulate", "sw_warp", "sw_warp_grads", "sw_accumulate_adjoint")
SLAB_PATH = ("slab_forward", "slab_backward")
# a registration's pose gradient runs back through the detector rays
# (geometry/se3.py transform_shared), once an iteration whatever the renderer
REGISTER_SW = (*SW_KERNELS, "rays_adjoint", "sw_content_boxes")
REGISTER_SLAB = (*SLAB_PATH, "rays_adjoint")


def stage_gaps(records, sw_stats, slab_stats, launches):
    """Device time above the bound per registration, in ms: for the kernels of
    each registration, the sum over its stages of the stage's iterations (an
    iteration launches each kernel of its path once) times (device time -
    bound) at the stage's shape; for K7 and K8, their launches at the fine
    shape. -> name -> (gap ms or None without device times, iterations)."""
    out = {}
    for name, recs in records.items():
        stats = sw_stats if name in REGISTER_SW else slab_stats if name in SLAB_PATH else None
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


# ---------------------------------------------------------------------------
# phase 6: training (python -m xvr_tpu_torch.cli train / restart)
# ---------------------------------------------------------------------------

# scripts/deepfluoro/train/finetune.sh's configuration at full width
# (ResNet-34, batch 116 at 128^2, a foundation checkpoint by -c); only the
# step count is cut
CLI_FINETUNE = ["--r1", "135", "225", "--r2", "-45", "45", "--r3", "-15", "15",
                "--tx", "-150", "150", "--ty", "450", "1000", "--tz", "-150", "150",
                "--sdd", "1020", "--height", "128", "--delx", "2.1764375",
                "--model_name", "resnet34", "--batch_size", "116", "--lr", "0.001",
                "--n_warmup_itrs", "10", "--n_grad_accum_itrs", "1"]
# scripts/bench_train.py's unmasked ranges (beta +-30), the same otherwise
CLI_BENCH_TRAIN = [*CLI_FINETUNE[:4], "-30", "30", *CLI_FINETUNE[6:]]
TRAIN_WARMUP = 2  # first steps of a run left out of its median host time per step
TRAIN_PROFILED = 2  # last steps of a run, profiled by torch.profiler and left out too


def train_windows(n: int) -> tuple[range, range]:
    """A run of ``n`` steps -> (step indices whose host times make the
    median, step indices profiled): the profiled steps come after the timed
    ones, so that no timed step runs under the profiler."""
    return range(TRAIN_WARMUP, max(n - TRAIN_PROFILED, TRAIN_WARMUP)), range(max(n - TRAIN_PROFILED, 0), n)


def foundation_checkpoint(path, ranges=None, config=MODEL_CONFIG, seed=0, head_std=2e-3,
                          device="cuda"):
    """Write a checkpoint (the JAX layout, no trained weights) that stands in
    for finetune.sh's foundation model: a seeded random backbone, head
    biases at the middle of ``ranges`` (ZXY degrees, mm about the volume
    centre) and small random head kernels (``head_std``), so that the
    predicted poses spread about the middle and their re-renders view the
    volume. -> path."""
    import torch
    from xvr_tpu_torch.geometry import convert
    from xvr_tpu_torch.models import PoseRegressor, init_pose_regressor
    from xvr_tpu_torch.state import to_flax_params
    from xvr_tpu_torch.train import save_checkpoint

    r = FINETUNE_RANGES if ranges is None else ranges
    mid = {k: (r[k + "min"] + r[k + "max"]) / 2 for k in ("alpha", "beta", "gamma", "tx", "ty", "tz")}
    mean = convert(torch.tensor([[mid["alpha"], mid["beta"], mid["gamma"]]]),
                   torch.tensor([[mid["tx"], mid["ty"], mid["tz"]]]),
                   "euler_angles", "ZXY", degrees=True)
    rot, xyz = mean.convert(config["parameterization"], config["convention"])
    gen = torch.Generator().manual_seed(seed)
    model = PoseRegressor(config["model_name"], config["parameterization"], config["convention"],
                          config["norm_layer"], config["unit_conversion_factor"])
    model = init_pose_regressor(model, gen)
    with torch.no_grad():
        for head, bias in ((model.rot_head, rot[0]),
                           (model.xyz_head, xyz[0] / config["unit_conversion_factor"])):
            head.weight.copy_(torch.randn(head.weight.shape, generator=gen) * head_std)
            head.bias.copy_(bias)
    save_checkpoint(path, to_flax_params(model.to(device)), {}, 0, 0, config)
    return path


def route_launches(route) -> dict:
    """Launches per training step that a route implies: per stratum, the
    target render and the re-render (K1 per channel, K2 over the fold) and
    the backward of the re-render (K3 over the fold, K4 per channel, and
    the rays' pose adjoint back to the CNN's predicted poses); the slab route
    K5 (K7 masked) twice, K6 once and the rays' adjoint once. The shear-warp
    operand's content boxes are made once a stratum (``Projector.prepare``),
    whatever the mesh."""
    C = 1 + len(route["labels"] or ())
    K = len(route["strata"])
    if route["renderer"] == "trilinear_pallas":
        fwd = "slab_channels" if route["labels"] else "slab_forward"
        return {fwd: 2, "slab_backward": 1, "rays_adjoint": 1}
    return {"sw_accumulate": 2 * K * C, "sw_warp": 2 * K, "sw_warp_grads": K,
            "sw_accumulate_adjoint": K * C, "rays_adjoint": K, "sw_content_boxes": K}


class watched_training:
    """Within the block, each Trainer that trains is kept with, per step,
    its host time after a device synchronization and its launches (the
    counts are not reset, so that a run's totals stay whole), its weights
    and optimizer state as training starts, a torch.profiler record of the
    last TRAIN_PROFILED steps (after the timed ones: ``train_windows``), and
    per step the foreground share of the re-render at the predicted poses
    (the render made with gradients on)."""

    def __enter__(self):
        import torch
        from xvr_tpu_torch.render import _cuda
        from xvr_tpu_torch.train import Trainer

        self.runs, self.orig = [], (Trainer.train, Trainer.step, Trainer.render_batch)
        cuda = torch.cuda.is_available()

        def sync():
            if cuda:
                torch.cuda.synchronize()

        def train(tr, *a, **k):
            n = tr.n_total_itrs - tr.start_itr
            timed, profiled = train_windows(n)
            self.runs.append(dict(
                trainer=tr, steps=[], prof=None, timed=timed, profiled=profiled, rerender=None,
                weights={n: p.detach().clone() for n, p in tr.model.named_parameters()},
                opt_state={k: v if isinstance(v, int) else {n: t.clone() for n, t in v.items()}
                           for k, v in tr.opt_state.items()}))
            return self.orig[0](tr, *a, **k)

        def step(tr, itr):
            run = self.runs[-1]
            i = len(run["steps"])
            prof = None
            if cuda and len(run["profiled"]) and i == run["profiled"][0]:
                from torch.profiler import ProfilerActivity, profile

                sync()
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof.__enter__()
                run["prof_owner"] = prof
            sync()
            before = dict(_cuda.LAUNCHES)
            t0 = time.perf_counter()
            out = self.orig[1](tr, itr)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            rerender, run["rerender"] = run["rerender"], None
            fg = None if rerender is None else float((rerender.sum(dim=1) > 0).float().mean())
            run["steps"].append(dict(itr=itr, ms=ms, rerender_fg=fg,
                                     launches={k: v - before[k] for k, v in _cuda.LAUNCHES.items()}))
            if cuda and len(run["profiled"]) and i == run["profiled"][-1]:
                owner = run.pop("prof_owner")
                owner.__exit__(None, None, None)
                run["prof"] = step_device_ms(owner, len(run["profiled"]))
            return out

        def render_batch(tr, *a, **k):
            out = self.orig[2](tr, *a, **k)
            if torch.is_grad_enabled():  # the re-render; the target render runs under no_grad
                self.runs[-1]["rerender"] = out.detach()
            return out

        Trainer.train, Trainer.step, Trainer.render_batch = train, step, render_batch
        return self

    def __exit__(self, *exc):
        from xvr_tpu_torch.train import Trainer

        Trainer.train, Trainer.step, Trainer.render_batch = self.orig


def step_device_ms(prof, n_steps, top=6) -> dict:
    """Device time per step from a torch.profiler record of ``n_steps``
    steps: each kernel of DEVICE_KERNELS by wrapper name, the rest of the
    device time (the CNN, the losses, the optimizer) and the total; and on
    the host, the ATen operator calls per step and the ``top`` host events
    (operators, CUDA runtime calls) by self CPU time per step."""
    import re

    from torch.autograd import DeviceType

    total, by_name = 0.0, dict.fromkeys(DEVICE_KERNELS, 0.0)
    host, calls = [], 0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            calls += ev.count if ev.key.startswith("aten::") else 0
            host.append((float(ev.self_cpu_time_total) / 1e3 / n_steps, ev.key))
            continue
        t = float(ev.self_device_time_total)
        total += t
        for name, kernels in DEVICE_KERNELS.items():
            if any(re.search(rf"\b{k}\b", ev.key) for k in kernels):
                by_name[name] += t
    if not total:
        return None
    out = {k: v / 1e3 / n_steps for k, v in by_name.items() if v}
    out["rest"] = (total - sum(by_name.values())) / 1e3 / n_steps
    out["total"] = total / 1e3 / n_steps
    out["aten_calls"] = calls / n_steps
    out["host_top_ms"] = {k: t for t, k in sorted(host, reverse=True)[:top]}
    return out


def train_run(name, argv, card, kernels):
    """Run ``python -m xvr_tpu_torch.cli <argv>`` in process with the launch
    counts of this run alone; print its route, per-step times, device time
    by kernel, launches per step against the route's, peak memory and the
    loss, kept share and re-render foreground share of each step. Fails on a
    non-finite loss, weights that did not move, no checkpoint, re-renders
    at the predicted poses that miss the volume throughout, or launches that differ
    from the route's or from step to step (``kernels=()``, without a card,
    skips the launch checks).
    -> (run record, stats)."""
    import numpy as np
    import torch
    from xvr_tpu_torch.cli import main

    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0  # what earlier phases hold
    with watched_training() as w:
        t0 = time.perf_counter()
        _, launches = counted(kernels, lambda: main(argv))
        wall = time.perf_counter() - t0
    if len(w.runs) != 1:
        raise AssertionError(f"{name}: {len(w.runs)} trainings, not 1")
    run = w.runs[0]
    tr = run["trainer"]
    route = tr.route()
    logged = [json.loads(line) for line in (tr.outpath / "train_log.jsonl").read_text().splitlines()]
    logged = [m for m in logged if m["itr"] >= tr.start_itr][-len(run["steps"]):]
    expect = route_launches(route)
    per_step = [{k: v for k, v in s["launches"].items() if v} for s in run["steps"]]
    ms = [s["ms"] for s in run["steps"]]
    fg = [s["rerender_fg"] for s in run["steps"]]
    timed = [ms[i] for i in run["timed"]] or ms
    t_steps = (f"{run['timed'][0] + 1}-{run['timed'][-1] + 1}" if len(run["timed"])
               else f"1-{len(ms)}")
    stats = dict(wall_s=wall, route=route, steps=len(ms), start_itr=tr.start_itr,
                 ms_per_step_median=float(np.median(timed)), ms_per_step=ms,
                 timed_steps=t_steps, profiled_steps=[i + 1 for i in run["profiled"]],
                 device_ms_per_step=run["prof"],
                 launches_per_step=per_step[0] if all(p == per_step[0] for p in per_step) else per_step,
                 launches_per_step_route=expect, rerender_fg_share=fg,
                 max_memory_allocated_gib=(torch.cuda.max_memory_allocated() / 2**30
                                           if cuda else None),
                 memory_held_before_gib=base / 2**30 if cuda else None,
                 loss=[m["loss"] for m in logged], kept=[m["kept"] for m in logged])
    log(f"train: {name}: route {route['renderer']}, strata "
        + ", ".join(f"[{s['alpha'][0]:.0f},{s['alpha'][1]:.0f}]x{s['count']} perm {s['perm']}"
                    + (f" label slabs {s['bounds'][1:]}" if s["bounds"] else "") for s in route["strata"])
        + f"; {len(ms)} steps from itr {tr.start_itr}, wall {wall:.2f} s [{card}]")
    log(f"  host ms per step (synchronized) {[round(t, 2) for t in ms]}; median of steps "
        f"{t_steps} {stats['ms_per_step_median']:.2f} ms")
    prof = run["prof"]
    if prof is not None:
        kern = {k: v for k, v in prof.items() if k in DEVICE_KERNELS}
        stats["device_idle_share"] = 1.0 - prof["total"] / stats["ms_per_step_median"]
        log(f"  device ms per step (torch.profiler, steps {[i + 1 for i in run['profiled']]}): "
            + ", ".join(f"{k} {v:.3f}" for k, v in kern.items())
            + f", rest {prof['rest']:.3f}, total {prof['total']:.3f} (kernels' share "
            f"{sum(kern.values()) / prof['total']:.3f}; idle share of the median step "
            f"{stats['device_idle_share']:.3f})")
        log(f"  host: {prof['aten_calls']:.0f} ATen calls per step; most self CPU ms per step: "
            + ", ".join(f"{k} {v:.2f}" for k, v in prof["host_top_ms"].items()))
    else:
        log("  device ms per step: not measured")
    log(f"  launches per step {json.dumps(stats['launches_per_step'])} (the route's "
        f"{json.dumps(expect)}); run totals {json.dumps(launches)}")
    mem = stats["max_memory_allocated_gib"]
    log(f"  max_memory_allocated {'not measured' if mem is None else f'{mem:.3f} GiB'} (of "
        f"which held before the run: "
        f"{'not measured' if mem is None else f'{stats['memory_held_before_gib']:.3f} GiB'})")
    log(f"  loss {[round(v, 5) for v in stats['loss']]}; kept {[round(v, 3) for v in stats['kept']]}; "
        f"re-render foreground share {[round(v, 3) for v in fg]}")

    moved = any(not torch.equal(p.detach(), run["weights"][n])
                for n, p in tr.model.named_parameters())
    ckpts = sorted(p.name for p in tr.outpath.glob("*.ckpt"))
    if not all(np.isfinite(stats["loss"])) or len(stats["loss"]) != len(ms):
        raise AssertionError(f"{name}: losses {stats['loss']}")
    if not moved:
        raise AssertionError(f"{name}: the weights did not change")
    if not ckpts:
        raise AssertionError(f"{name}: no checkpoint written")
    if None in fg or not np.mean(fg) > 0:
        raise AssertionError(f"{name}: the re-render at the predicted poses misses the volume: {fg}")
    if kernels:
        bad = [(s["itr"], p) for s, p in zip(run["steps"], per_step) if p != expect]
        if bad:
            raise AssertionError(f"{name}: launches per step differ from the route's {expect}: {bad}")
    return run, stats


def phase_training(workdir: Path, hu, aff, card, dev="cuda", kernels=SW_KERNELS,
                   finetune=CLI_FINETUNE, bench=CLI_BENCH_TRAIN):
    """``train`` masked (the finetune configuration from a foundation
    checkpoint, 12 steps, a checkpoint every 4), ``train`` unmasked
    (bench_train's ranges, the same checkpoint, 8 steps) and ``restart``
    from the masked run's step-4 checkpoint (8 steps), through the CLI on
    the 256^3 CT with the two-label mask. ``kernels=()`` skips the launch
    checks (no card). -> stats."""
    import numpy as np
    from xvr_tpu_torch.io import save_nifti
    from xvr_tpu_torch.train import load_checkpoint
    from xvr_tpu_torch.state import to_flax_params

    ct, mask = workdir / "train_ct.nii.gz", workdir / "train_mask.nii.gz"
    save_nifti(ct, hu, aff)
    save_nifti(mask, train_mask(hu.shape[0]).astype(np.float32), aff)
    os.environ["XVR_LOG_DIR"] = str(workdir / "runs")
    base = ["--device", dev]
    stats = {}
    # the foundation model finetune.sh starts from (-c): its poses view the volume
    found = foundation_checkpoint(
        workdir / "foundation.ckpt", device=dev,
        config=dict(MODEL_CONFIG, model_name=finetune[finetune.index("--model_name") + 1]))

    out_m = workdir / "train_masked"
    _, stats["masked"] = train_run(
        "train masked (finetune)",
        ["train", "-v", str(ct), "-m", str(mask), "-c", str(found), "-o", str(out_m), *finetune,
         "--n_total_itrs", "12", "--n_save_every_itrs", "4", *base],
        card, kernels)
    out_u = workdir / "train_unmasked"
    _, stats["unmasked"] = train_run(
        "train unmasked (bench_train ranges)",
        ["train", "-v", str(ct), "-c", str(found), "-o", str(out_u), *bench,
         "--n_total_itrs", "8", "--n_save_every_itrs", "8", *base], card, kernels)

    # restart from the masked run's checkpoint of step 4 (0001.ckpt): it
    # resumes there with the optimizer state that checkpoint holds
    mid = workdir / "restart_from.ckpt"
    mid.write_bytes((out_m / "0001.ckpt").read_bytes())
    saved = load_checkpoint(mid)
    run, stats["restart"] = train_run("restart (from the masked run's step 4)",
                                      ["restart", "-c", str(mid), *base], card, kernels)
    tr, st = run["trainer"], run["opt_state"]
    opt = saved["optimizer_state_dict"]
    adam = opt["inner_opt_state"]["1"]["0"]
    counts_ok = (st["gradient_step"], st["adam_count"], st["schedule_count"], st["mini_step"]) == (
        int(opt["gradient_step"]), int(adam["count"]), int(opt["inner_opt_state"]["1"]["1"]["count"]),
        int(opt["mini_step"]))
    moments_ok = all(
        all(np.array_equal(a, b) for a, b in zip(_leaves(to_flax_params(tr.model, st[m])),
                                                  _leaves(adam[m])))
        for m in ("mu", "nu"))
    log(f"train: restart resumed at itr {tr.start_itr} (the checkpoint's {saved['itr']}); "
        f"optimizer counts read back {counts_ok}, mu/nu bit for bit {moments_ok}; first loss "
        f"{stats['restart']['loss'][0]:.5f}")
    if not (tr.start_itr == int(saved["itr"]) and counts_ok and moments_ok
            and np.isfinite(stats["restart"]["loss"][0])):
        raise AssertionError("restart did not resume from its checkpoint")
    stats["restart"].update(resumed_itr=tr.start_itr, optimizer_state_read_back=True)
    return stats


# ---------------------------------------------------------------------------
# phase 7: the rest (the device mesh, the lean scan, animate, dcm2nii)
# ---------------------------------------------------------------------------

# phase 4's registrar cut only in iterations per stage (plateau exits end
# stages sooner), for the sharded registration's two runs
REST_REGISTER_ITRS = "60,40,30"
REST_TRAIN_STEPS = 8  # the median leaves out the first TRAIN_WARMUP
# the golden renderers on the card: the scan against the sample-tensor march
# (float32 sums over the same samples in another order), a card frame of
# animate against the CPU's (float32 on both, fused multiply-adds on the card)
SCAN_RTOL = 1e-4
FRAME_RTOL = 1e-4
# the ray-sharded forward is bit-identical by construction; were it not, a
# difference up to this share of max|render| is reported and passes
RAY_SHARDED_BOUND = 1e-6
# the sharded registration against the mesh-free one: each image's final
# pose within this mTRE (mm) of the mesh-free run's same image
SHARDED_POSE_BOUND_MM = 0.5
TRAIN_LOSS_RTOL = 1e-4


def rest_scan(proj, pose4, time_ms=cuda_time_ms):
    """``raymarch_trilinear_scan`` against ``raymarch_trilinear`` at the fine
    stage (B=4, 239^2, the projector's samples): max error, time and peak
    memory above what was held before each."""
    import torch
    from xvr_tpu_torch.render import xla

    fine = proj.rescale_detector(stage_cases(proj, pose4, pose4)[-1][2])
    cuda = fine.device.type == "cuda"
    with torch.no_grad():
        src, tgt = fine.rays(pose4)
        args = (fine.density, fine.affine_inverse, src, tgt)
        calls = {"scan": lambda: xla.raymarch_trilinear_scan(*args, n_samples=fine.n_samples),
                 "golden": lambda: xla.raymarch_trilinear(*args, n_samples=fine.n_samples)}
        out, peak = {}, {}
        for name, fn in calls.items():
            if cuda:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            out[name] = fn()
            if cuda:
                torch.cuda.synchronize()
                peak[name] = (torch.cuda.max_memory_allocated() - base) / 2**20
        # the peak's call above warmed each up; the scan takes ~2 s a call
        ms = {name: time_ms(fn, 1, warmup=0) for name, fn in calls.items()}
    B, R = tgt.shape[:2]
    shape = f"B={B} x {fine.detector.height}^2, {fine.n_samples} samples"
    err = check("scan", out["scan"], out["golden"], f"vs raymarch_trilinear [{shape}]",
                atol=SCAN_RTOL * float(out["golden"].abs().max()), rtol=SCAN_RTOL)
    fmt = lambda v: "not measured" if v is None else f"{v:.1f} MiB"  # noqa: E731
    log(f"rest: scan {ms['scan']:.3f} ms, peak {fmt(peak.get('scan'))}; raymarch_trilinear "
        f"{ms['golden']:.3f} ms, peak {fmt(peak.get('golden'))} (its ray_chunk bounds each "
        f"(B, R, S, 3) piece to 2^25 samples) [{shape}]")
    return dict(shape=shape, max_abs_err=err, ms=ms["scan"], golden_ms=ms["golden"],
                peak_mib=peak.get("scan"), golden_peak_mib=peak.get("golden"))


def rest_ray_sharded(sw_proj, pose4, kernels=SW_KERNELS, time_ms=cuda_time_ms):
    """``ray_sharded_fast_render`` on a mesh of 4 slots of one device (rays
    2) at the fine stage, B=1 (the rows over all 4 slots, 239 padded to 240)
    and B=4 (the batch over dp, the rows over rays): the forward against the
    unsharded fast render, bit for bit (or within RAY_SHARDED_BOUND), the
    pose gradient with JAX's tolerance (rtol 2e-2, atol 1e-4 max, cosine
    > 1 - 1e-6), launches of each forward and backward, and the times."""
    import torch
    from xvr_tpu_torch.geometry import RigidTransform
    from xvr_tpu_torch.parallel import make_mesh, ray_sharded_fast_render

    fine = sw_proj.rescale_detector(stage_cases(sw_proj, pose4, pose4)[-1][2])
    dev = fine.device
    mesh = make_mesh(4, rays=2, devices=[dev] * 4)
    prep = fine.prepare()
    fwd = tuple(k for k in kernels if k in ("sw_accumulate", "sw_warp"))
    out = {}
    for B in (1, 4):
        pose = RigidTransform(pose4.matrix[:B])

        def sharded(p=pose):
            return ray_sharded_fast_render(mesh, fine, p, prepared=prep)

        def whole(p=pose):
            return fine.render_rays(*fine.rays(p), prepared=prep)

        with torch.no_grad():
            got, launches = counted(fwd, sharded)
            ref = whole()
        same = bool(torch.equal(got, ref))
        diff = float((got - ref).abs().max())
        scale = float(ref.abs().max())

        def grad(render):
            m = pose.matrix.clone().requires_grad_(True)
            (g,) = torch.autograd.grad((render(RigidTransform(m)) ** 2).sum(), m)
            return g.double().ravel()

        g_sh, bwd_launches = counted(kernels, lambda: grad(sharded))
        g_ref = grad(whole)
        # the unsharded gradient again: the warp transpose's scatter_add_ adds
        # in the order its atomics land, so a repeat need not match its bits
        repeats = bool(torch.equal(g_ref, grad(whole)))
        g_err = float((g_sh - g_ref).abs().max())
        g_tol = 1e-4 * float(g_ref.abs().max()) + 2e-2 * g_ref.abs()
        g_ok = bool(((g_sh - g_ref).abs() <= g_tol).all())
        cos = float(g_sh @ g_ref / (g_sh.norm() * g_ref.norm()))
        with torch.no_grad():
            ms, whole_ms = time_ms(sharded, 10), time_ms(whole, 10)
        blocks = mesh.size  # B=4: 2 batch blocks x 2 row blocks; B=1: 4 row blocks
        log(f"rest: ray-sharded render B={B} [{fine.detector.height}^2, mesh {mesh.shape} of one "
            f"device, {blocks} blocks]: bit-identical to the unsharded render {same} (max |diff| "
            f"{diff:.3e}, bound {RAY_SHARDED_BOUND:g} x max {scale:.3e}); pose gradient max |diff| "
            f"{g_err:.3e} within rtol 2e-2 / atol 1e-4 max {g_ok}, cosine {cos:.12f} (> 1 - 1e-6), "
            f"the unsharded gradient repeats bit for bit {repeats}; "
            f"launches forward {json.dumps({k: v for k, v in launches.items() if v})}, with the "
            f"backward {json.dumps({k: v for k, v in bwd_launches.items() if v})}; "
            f"{ms:.4f} ms sharded, {whole_ms:.4f} ms unsharded")
        if not (diff <= RAY_SHARDED_BOUND * scale and g_ok and cos > 1.0 - 1e-6):
            raise AssertionError(f"ray-sharded render B={B} disagrees with the unsharded render")
        if kernels and launches["sw_accumulate"] != blocks:
            raise AssertionError(f"ray-sharded render B={B}: {launches['sw_accumulate']} K1 "
                                 f"launches for {blocks} row blocks")
        out[f"B{B}"] = dict(bit_identical=same, max_abs_diff=diff, grad_max_abs_diff=g_err,
                            grad_cosine=cos, unsharded_grad_repeats=repeats, launches=launches, launches_with_backward=bwd_launches,
                            ms=ms, unsharded_ms=whole_ms, blocks=blocks)
    return out


def batch_independence(reg, gt_pose, n=12, k=8, seed=11):
    """Which step of one registration iteration depends on the batch: ``n``
    poses about ``gt_pose`` at the registrar's fine stage, the first ``k``
    of them alone against the same ``k`` inside the batch of ``n``, bit for
    bit: the fast render, the X-ray transforms, the similarity (the
    registrar's defaults), the similarity's gradient by the transformed
    images, the render's gradient by its rays (source and targets) and by
    the pose for a fixed cotangent, and the whole pose gradient. -> name ->
    equal."""
    import numpy as np
    import torch
    from xvr_tpu_torch.geometry import convert
    from xvr_tpu_torch.metrics.ncc import make_imagesim
    from xvr_tpu_torch.registrar.base import _parse_scales
    from xvr_tpu_torch.utils.transforms import make_xray_transforms

    H = reg.projector.detector.height
    proj = reg.projector.rescale_detector(_parse_scales(reg.scales, reg.crop, H)[-1])
    det = proj.detector
    transform = make_xray_transforms(det.height, det.width)
    imagesim = make_imagesim(9, 11, 0.0, 0.5)
    dev = proj.device
    rng = np.random.default_rng(seed)
    rot0, xyz0 = gt_pose.convert("euler_angles", "ZXY")
    rot = rot0.reshape(1, 3) + torch.tensor(rng.uniform(-0.01, 0.01, (n, 3)), dtype=torch.float32,
                                            device=dev)
    xyz = xyz0.reshape(1, 3) + torch.tensor(rng.uniform(-2.0, 2.0, (n, 3)), dtype=torch.float32,
                                            device=dev)
    prepared = proj.prepare()
    with torch.no_grad():
        gt = transform(proj(gt_pose, prepared=prepared)).expand(n, -1, -1, -1)
    cot = torch.randn((n, 1, det.height, det.width), generator=torch.Generator(dev).manual_seed(seed),
                      device=dev)

    def step(m):
        r, x = rot[:m].clone().requires_grad_(True), xyz[:m].clone().requires_grad_(True)
        img = proj(convert(r, x, "euler_angles", "ZXY"), prepared=prepared)
        tr = transform(img)
        sims = imagesim(gt[:m], tr)
        g_tr, g_r, g_x = torch.autograd.grad(sims.sum(), (tr, r, x), retain_graph=True)
        render_g = torch.autograd.grad((img * cot[:m]).sum(), (r, x))
        src, tgt = (t.detach().requires_grad_(True)
                    for t in proj.rays(convert(rot[:m], xyz[:m], "euler_angles", "ZXY")))
        raw = proj.render_rays(src, tgt, prepared=prepared)
        ray_g = torch.autograd.grad((raw * cot[:m].reshape(m, -1)).sum(), (src, tgt))
        return dict(render=img, transforms=tr, similarity=sims, similarity_grad=g_tr,
                    render_ray_grad=torch.cat([g.reshape(m, -1) for g in ray_g], 1),
                    render_grad=torch.cat(render_g, 1), gradient=torch.cat([g_r, g_x], 1))

    whole, part = step(n), step(k)
    return {name: bool(torch.equal(whole[name][:k].detach(), part[name].detach())) for name in whole}


def rest_sharded_registration(workdir: Path, gt_pose, fids, dev="cuda", kernels=SW_KERNELS,
                              n_itrs=REST_REGISTER_ITRS):
    """``run_batch([xray] * 3)`` with phase 4's registrar (iterations cut to
    ``n_itrs``) on a 2-slot mesh of one device, padded to 4 images, against
    the mesh-free ``run_batch`` of the same images: each image's final pose,
    bit for bit or within SHARDED_POSE_BOUND_MM; the sharded run's launches,
    ms/itr and mTRE (reported: the iterations are cut)."""
    import numpy as np
    from xvr_tpu_torch.parallel import make_mesh

    xray = workdir / "xray.dcm"
    gt_np = gt_pose.matrix[0].cpu().numpy()
    mesh = make_mesh(2, devices=[dev] * 2)
    runs = {}
    for name, m in (("mesh", mesh), ("mesh-free", None)):
        reg = bench_registrar(workdir, gt_pose, n_itrs, dev, mesh=m, verbose=0)
        t0 = time.perf_counter()
        res, launches = counted(kernels, lambda r=reg: r.run_batch([xray] * 3))
        runs[name] = dict(reg=reg, res=res, launches=launches, wall=time.perf_counter() - t0)
    poses = {k: [r[4].matrix.cpu().numpy().reshape(4, 4) for r in v["res"]] for k, v in runs.items()}
    mtre = {k: [fiducial_mtre(p, gt_np, fids) for p in v] for k, v in poses.items()}
    apart = [fiducial_mtre(a, b, fids) for a, b in zip(poses["mesh"], poses["mesh-free"])]
    same = [bool(np.array_equal(a, b)) for a, b in zip(poses["mesh"], poses["mesh-free"])]
    diff = [float(np.abs(a - b).max()) for a, b in zip(poses["mesh"], poses["mesh-free"])]
    reg_m = runs["mesh"]["reg"]
    log(f"rest: sharded registration run_batch([xray] * 3) on mesh {mesh.shape} of one device "
        f"(padded to {reg_m.stage_log[0]['K'] // 16} images; n_itrs {n_itrs}): wall "
        f"{runs['mesh']['wall']:.2f} s against {runs['mesh-free']['wall']:.2f} s mesh-free; "
        f"launches {json.dumps(runs['mesh']['launches'])} (mesh-free "
        f"{json.dumps(runs['mesh-free']['launches'])})")
    for rec, ref in zip(reg_m.stage_log, runs["mesh-free"]["reg"].stage_log):
        log(f"  stage {rec['stage']} K={rec['K']} {rec['height']}x{rec['width']}: "
            f"{rec['n_done']} itrs, {rec['ms_per_itr']:.2f} ms/itr (mesh-free K={ref['K']}: "
            f"{ref['n_done']} itrs, {ref['ms_per_itr']:.2f} ms/itr)")
    log(f"rest: sharded registration final poses = the mesh-free run's bit for bit {same}; max "
        f"|diff| {[f'{d:.3e}' for d in diff]}, apart {[round(a, 4) for a in apart]} mm mTRE "
        f"(<= {SHARDED_POSE_BOUND_MM}); mTRE sharded {[round(v, 4) for v in mtre['mesh']]}, "
        f"mesh-free {[round(v, 4) for v in mtre['mesh-free']]} mm")
    same_parts = batch_independence(reg_m, gt_pose)
    log(f"rest: one iteration's steps for 8 poses alone = the same 8 inside a batch of 12, bit "
        f"for bit: {json.dumps(same_parts)}")
    if len(runs["mesh"]["res"]) != 3 or reg_m.stage_log[0]["K"] != 4 * 16:
        raise AssertionError("the sharded run_batch did not pad 3 images to 4 and return 3")
    if max(apart) > SHARDED_POSE_BOUND_MM:
        raise AssertionError("the sharded registration strays from the mesh-free one")
    return dict(n_itrs=n_itrs, wall_s=runs["mesh"]["wall"], mesh_free_wall_s=runs["mesh-free"]["wall"],
                launches=runs["mesh"]["launches"], bit_identical=same, max_abs_diff=diff,
                batch_independent=same_parts,
                apart_mm=apart, mtre_mm=mtre["mesh"], mesh_free_mtre_mm=mtre["mesh-free"],
                stages=[dict(stage=r["stage"], K=r["K"], det=r["height"], n_done=r["n_done"],
                             ms_per_itr=r["ms_per_itr"], mesh_free_n_done=f["n_done"],
                             mesh_free_ms_per_itr=f["ms_per_itr"])
                        for r, f in zip(reg_m.stage_log, runs["mesh-free"]["reg"].stage_log)])


def rest_sharded_training(workdir: Path, card, dev="cuda", kernels=SW_KERNELS,
                          steps=REST_TRAIN_STEPS):
    """Phase 6's masked finetune configuration (the config its first
    checkpoint holds, as ``restart`` reads it) through ``Trainer`` on a
    2-slot mesh of one device, ``steps`` steps: step 1's loss against the
    mesh-free trainer's at equal draws (both seeded alike; cuDNN's TF32 off
    for that step), ms per step (the median without the first TRAIN_WARMUP)
    and launches per step against the route's (once per slot)."""
    import numpy as np
    import torch
    from xvr_tpu_torch.parallel import make_mesh
    from xvr_tpu_torch.render import _cuda
    from xvr_tpu_torch.train import Trainer, load_checkpoint

    cfg = dict(load_checkpoint(workdir / "train_masked" / "0000.ckpt")["config"],
               outpath=workdir / "mesh_train", n_total_itrs=steps)
    cuda = dev == "cuda"
    mesh = make_mesh(2, devices=[dev] * 2)
    ref = Trainer(**{**cfg, "outpath": workdir / "mesh_train_ref"}, device=dev)
    tr = Trainer(**cfg, mesh=mesh, device=dev)
    expect = {k: v if k == "sw_content_boxes" else v * mesh.size
              for k, v in route_launches(tr.route()).items()}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        loss_ref = float(ref.step(0)["loss"])
        ms, per_step, losses = [], [], []
        for itr in range(steps):
            if itr == 1:
                torch.backends.cudnn.allow_tf32 = tf32
            sync()
            before = dict(_cuda.LAUNCHES)
            t0 = time.perf_counter()
            losses.append(float(tr.step(itr)["loss"]))
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            per_step.append({k: v - before[k] for k, v in _cuda.LAUNCHES.items() if v - before[k]})
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    rel = abs(losses[0] - loss_ref) / abs(loss_ref)
    med = float(np.median(ms[TRAIN_WARMUP:]))
    log(f"rest: sharded training (finetune, masked, batch {tr.batch_size} at {tr.height}^2, "
        f"{tr.config['model_name']}) on mesh {mesh.shape} of one device: step 1 loss "
        f"{losses[0]:.6f} against the mesh-free step's {loss_ref:.6f} (rel {rel:.2e} <= "
        f"{TRAIN_LOSS_RTOL:g}); ms per step {[round(t, 2) for t in ms]}, median of steps "
        f"{TRAIN_WARMUP + 1}-{steps} "
        f"{med:.2f} [{card}]; launches per step {json.dumps(per_step[0])} (the route's once per "
        f"slot: {json.dumps(expect)}); losses {[round(v, 5) for v in losses]}")
    if not (rel <= TRAIN_LOSS_RTOL and all(np.isfinite(losses))):
        raise AssertionError("the sharded training step's loss is not the mesh-free step's")
    if kernels and any(p != expect for p in per_step):
        raise AssertionError(f"sharded training launches {per_step}, not the route's x2 {expect}")
    stats = dict(loss=losses, mesh_free_loss=loss_ref, rel_loss_diff=rel, ms_per_step=ms,
                 ms_per_step_median=med, launches_per_step=per_step[0], launches_expected=expect)
    del ref, tr
    if cuda:
        torch.cuda.empty_cache()
    return stats


def rest_animate(workdir: Path, dev="cuda", frames=20, checked=3):
    """animate's re-rendering half on ``dev`` (``render_trajectory``) over
    phase 5's ``register restart`` bundle at a ``--skip`` that gives about
    ``frames`` frames; ``checked`` of them (first, middle, last) against the
    same frames re-rendered on the CPU (FRAME_RTOL of each frame's max)."""
    import numpy as np
    import torch
    from xvr_tpu_torch.visualization import load_bundle, render_trajectory

    bundle = workdir / "out_restart" / "xray"
    arrays, meta = load_bundle(bundle)
    n = len(arrays["trajectory_params"])
    skip = max(1, round(n / frames))
    t0 = time.perf_counter()
    got = render_trajectory(bundle, skip, dev)
    if dev == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(meta["optimization"]["scales"]) != 1:
        raise AssertionError("the restart bundle should have one pyramid stage")
    # the checked frames' poses as a bundle of their own (one stage: no
    # pyramid advance to replay), re-rendered on the CPU
    pick = sorted({0, len(got) // 2, len(got) - 1})[:checked]
    rows = [got[i][0] for i in pick]
    sub = workdir / "animate_cpu"
    sub.mkdir(exist_ok=True)
    np.savez(sub / "parameters.npz", **{**arrays, "trajectory_params": arrays["trajectory_params"][rows],
                                         "trajectory_lrs": arrays["trajectory_lrs"][rows]})
    (sub / "parameters.json").write_text(json.dumps(meta))
    cpu = render_trajectory(sub, 1, "cpu")
    errs = []
    for i, (_, img, xray) in zip(pick, cpu):
        for name, a, b in (("DRR", got[i][1], img), ("X-ray", got[i][2], xray)):
            err = float(np.abs(a - b).max())
            tol = FRAME_RTOL * float(np.abs(b).max())
            errs.append(err)
            if not (a.shape == b.shape and np.isfinite(a).all() and err <= tol):
                raise AssertionError(f"animate frame {got[i][0]} {name}: card vs CPU {err} > {tol}")
    fps = len(got) / wall
    log(f"rest: animate render_trajectory on {dev} over the register restart bundle ({n} rows, "
        f"--skip {skip}): {len(got)} frames of {got[0][1].shape[0]}^2 in {wall:.2f} s, {fps:.2f} "
        f"frames/s (the CT's load included); frames {[got[i][0] for i in pick]} against the CPU: "
        f"max |diff| {max(errs):.3e} (<= {FRAME_RTOL:g} x each frame's max)")
    return dict(rows=n, skip=skip, frames=len(got), wall_s=wall, frames_per_s=fps,
                checked=[got[i][0] for i in pick], max_abs_err=max(errs))


def rest_dcm2nii(workdir: Path):
    """``python -m xvr_tpu_torch.cli dcm2nii`` in process on a 16x12x8 series
    written with the port's dcmwrite in shuffled order: the volume and the
    LPS -> RAS affine are the values written."""
    import numpy as np
    from xvr_tpu_torch.cli import main
    from xvr_tpu_torch.io import dcmwrite, load_nifti

    rows, cols, n, sp_r, sp_c, dz = 16, 12, 8, 1.5, 2.0, 3.0
    rng = np.random.default_rng(0)
    hu = rng.integers(-1000, 1500, size=(rows, cols, n)).astype(np.float32)
    origin = np.array([5.0, -7.0, 11.0])
    series = workdir / "series"
    series.mkdir(exist_ok=True)
    for k in rng.permutation(n):
        extra = [(0x0020, 0x0032, b"DS", [f"{v:g}" for v in origin + [0.0, 0.0, dz * k]]),
                 (0x0020, 0x0037, b"DS", ["1", "0", "0", "0", "1", "0"]),
                 (0x0028, 0x1052, b"DS", "-1024"), (0x0028, 0x1053, b"DS", "1"),
                 (0x0018, 0x0050, b"DS", f"{dz:g}")]
        dcmwrite(series / f"slice_{n - k:03d}.dcm", (hu[:, :, k] + 1024.0).astype(np.uint16),
                 sdd=0.0, row_spacing=sp_r, col_spacing=sp_c, extra=extra)
    out = workdir / "series.nii.gz"
    t0 = time.perf_counter()
    main(["dcm2nii", str(series), str(out)])
    wall = time.perf_counter() - t0
    data, affine = load_nifti(out)
    # axis 0 = rows (along the column direction), 1 = columns, 2 = the
    # normal; LPS -> RAS flips the first two world axes
    expect = np.eye(4)
    expect[:3, 0] = [0.0, -sp_r, 0.0]
    expect[:3, 1] = [-sp_c, 0.0, 0.0]
    expect[:3, 2] = [0.0, 0.0, dz]
    expect[:3, 3] = [-origin[0], -origin[1], origin[2]]
    ok = data.shape == hu.shape and np.array_equal(data, hu) and np.allclose(affine, expect, atol=1e-6)
    log(f"rest: dcm2nii of a {rows}x{cols}x{n} series in {wall:.3f} s: volume and affine as "
        f"written {ok}")
    if not ok:
        raise AssertionError(f"dcm2nii: volume {data.shape} or affine {affine.tolist()} not as written")
    return dict(shape=list(data.shape), wall_s=wall)


def phase_rest(workdir: Path, proj, sw_proj, pose4, gt_pose, fids, card, dev="cuda",
               kernels=SW_KERNELS, register_itrs=REST_REGISTER_ITRS, time_ms=cuda_time_ms):
    """Phase 7 on phase 4's scene, after phases 5 and 6 (their bundle and
    training files). ``kernels=()`` skips the launch checks (no card).
    -> stats."""
    t0 = time.perf_counter()
    stats = dict(scan=rest_scan(proj, pose4, time_ms),
                 ray_sharded=rest_ray_sharded(sw_proj, pose4, kernels, time_ms),
                 sharded_registration=rest_sharded_registration(workdir, gt_pose, fids, dev,
                                                                kernels, register_itrs),
                 sharded_training=rest_sharded_training(workdir, card, dev, kernels),
                 animate=rest_animate(workdir, dev),
                 dcm2nii=rest_dcm2nii(workdir))
    stats["seconds"] = time.perf_counter() - t0
    log(f"rest: all checks passed ({stats['seconds']:.1f} s)")
    return stats


# ---------------------------------------------------------------------------
# phase 8: the dataset workflows (scripts/torch), on a DeepFluoro subject
# ---------------------------------------------------------------------------

KEPT_LABELS = (1, 2, 3, 4, 7)  # deepfluoro/register/*.sh's --labels
# the two X-rays' GT poses (ZXY degrees, mm): the bench pose and a second view
WORKFLOW_POSES = (((182.0, -4.0, 3.0), (6.0, 740.0, -10.0)),
                  ((176.5, 2.0, -2.5), (-8.0, 760.0, 6.0)))
WORKFLOW_SEEDS = 4  # RegistrarBase's restart_seeds: K = 2 X-rays x 4 seeds per render
IDENTITY_ITK = ("#Insight Transform File V1.0\n#Transform 0\n"
                "Transform: AffineTransform_double_3_3\n"
                "Parameters: 1 0 0 0 1 0 0 0 1 0 0 0\nFixedParameters: 0 0 0\n")
CSV_MTRE_ATOL = 1e-3  # mm: the evaluate CSV's float32 mTRE against the phase's float64 one
FEMUR_SHARE_MAX = 0.1  # of the bone, in the two boxes that --labels 1,2,3,4,7 leaves out


def _load_script(name):
    """A workflow script of scripts/torch as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"torch_{name}", REPO / "scripts" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def deepfluoro_mask(hu):
    """DeepFluoro's seven labels on the bench phantom: 1 soft tissue, 2/3 the
    rod's halves, 4 the plate, 7 the ball, and 5/6 ("the femurs") the bone in
    two lateral boxes at the rod's ends. -> (int32 labelmap, each label's
    share of the bone)."""
    import numpy as np

    n = hu.shape[0]
    X, Y, Z = np.meshgrid(*([np.arange(n, dtype=np.float32)] * 3), indexing="ij")
    bone = hu > 600.0
    mask = np.where(hu > -500.0, 1, 0).astype(np.int32)
    mask[bone & (Z < (n - 1) / 2)] = 2
    mask[bone & (Z >= (n - 1) / 2)] = 3
    plate = (np.abs(X - 0.35 * n) < 0.04 * n) & (np.abs(Y - 0.55 * n) < 0.12 * n) & (
        np.abs(Z - 0.35 * n) < 0.12 * n)
    mask[bone & plate] = 4
    mask[bone & ((X - 0.62 * n) ** 2 + (Y - 0.45 * n) ** 2 + (Z - 0.6 * n) ** 2 <= (0.1 * n) ** 2)] = 7
    mask[bone & (X < 0.32 * n) & (Z > 0.55 * n)] = 5
    mask[bone & (X > 0.69 * n)] = 6
    shares = {int(k): float((mask[bone] == k).mean()) for k in (2, 3, 4, 5, 6, 7)}
    return mask, shares


def masked_hu(hu):
    """The CT as ``-m mask --labels 1,2,3,4,7`` reads it: air outside the kept labels."""
    import numpy as np

    return np.where(np.isin(deepfluoro_mask(hu)[0], KEPT_LABELS), hu, -1000.0).astype(np.float32)


def workflow_poses(dev="cuda"):
    """The K = 2 x WORKFLOW_SEEDS poses of phase 8's renders about the
    WORKFLOW_POSES, seeded as RegistrarBase.run_batch seeds its first pass
    (pass index 999) with its default jitter: seed 0 of each X-ray as it is,
    the others moved by one shared table of +-1 degree and +-4 mm from
    default_rng(1000 + 999)."""
    import numpy as np
    import torch
    from xvr_tpu_torch.geometry import convert

    S, n = WORKFLOW_SEEDS, len(WORKFLOW_POSES)
    rot = np.repeat(np.deg2rad([p[0] for p in WORKFLOW_POSES]), S, axis=0)
    xyz = np.repeat(np.array([p[1] for p in WORKFLOW_POSES], np.float64), S, axis=0)
    prng = np.random.default_rng(1000 + 999)
    jit = (np.arange(n * S) % S) != 0
    rot[jit] += np.tile(np.deg2rad(prng.uniform(-1.0, 1.0, (S - 1, 3))), (n, 1))
    xyz[jit] += np.tile(prng.uniform(-4.0, 4.0, (S - 1, 3)), (n, 1))
    return convert(torch.tensor(rot, dtype=torch.float32, device=dev),
                   torch.tensor(xyz, dtype=torch.float32, device=dev), "euler_angles", "ZXY")


def phase_workflow_kernels(hu, aff, dev="cuda"):
    """K1-K4 against their plain versions (:func:`check_sw_stage`, phase 3's
    tolerances and bit-for-bit repeats) at phase 8's shapes: the masked
    density that ``--labels 1,2,3,4,7`` leaves (as phase 8 packs it for K1),
    the 1336^2 crop projector, B = 8 (:func:`workflow_poses`: both views x 4
    seeds) at the coarse, middle and fine scales of 24,12,6.
    -> {kernel: max abs error}."""
    import torch
    from xvr_tpu_torch.registrar.base import _parse_scales
    from xvr_tpu_torch.render import Projector, Volume, _cuda

    vol = Volume(data=torch.as_tensor(masked_hu(hu), device=dev), affine=torch.as_tensor(aff, device=dev))
    poses = workflow_poses(dev)
    proj = Projector.from_volume(vol, sdd=1020.0, height=1336, delx=0.194).with_shearwarp(poses)
    if not proj.renderer.endswith("_fast"):
        raise AssertionError(f"with_shearwarp declined the workflow poses: {proj.renderer}")
    packed = proj.prepare_for_shearwarp()
    errs = {}
    for stage, scale in zip(("coarse", "mid", "fine"),
                            _parse_scales("24,12,6", 100, proj.detector.height)):
        _, _, _, e, _ = check_sw_stage(packed, proj.rescale_detector(scale), poses,
                                       f"workflow {stage} B={poses.matrix.shape[0]} masked")
        errs = {k: max(errs.get(k, 0.0), v) for k, v in e.items()}
    _cuda.reset_launches()
    log(f"kernels: phase 8's shapes (masked density, both views x {WORKFLOW_SEEDS} seeds) passed, "
        f"max abs errors {json.dumps(errs)}")
    return errs


def write_deepfluoro_subject(root: Path, name, hu, aff, fids, dev="cuda", det=1436):
    """The tree scripts/torch/convert_datasets.py writes for one DeepFluoro
    subject, from the bench CT: data/deepfluoro/<name>/ volume.nii.gz,
    mask.nii.gz (deepfluoro_mask), fiducials.npy, an identity
    warp2template.txt, and xrays/00i.{dcm,npz} for the WORKFLOW_POSES, each
    a ``det``^2 X-ray (sdd 1020, 1436^2 x 0.194 mm) of the whole CT, the
    femur boxes in view as on real DeepFluoro X-rays, rendered by the port
    through shear-warp and stored as the intensity 2 exp(-k d) - 1
    (k = ln 2 / max d) that --linearize maps back to the line integral d,
    its pose before the mapper; then the finetuned checkpoint
    models/deepfluoro/finetuned/<name>/0001.ckpt (synthetic, fit to both
    X-rays as --linearize --crop 100 reads them). -> GT pose matrices
    (N, 4, 4)."""
    import numpy as np
    import torch
    from xvr_tpu_torch.geometry import convert
    from xvr_tpu_torch.io import dcmwrite, read, save_nifti
    from xvr_tpu_torch.render import Projector

    conv = _load_script("convert_datasets")
    mapper = _load_script("evaluate")._DEEPFLUORO_MAPPER  # its own inverse
    sub = root / "data" / "deepfluoro" / name
    (sub / "xrays").mkdir(parents=True)
    save_nifti(sub / "volume.nii.gz", hu, aff)
    save_nifti(sub / "mask.nii.gz", deepfluoro_mask(hu)[0].astype(np.float32), aff)
    np.save(sub / "fiducials.npy", np.asarray(fids, np.float32))
    (sub / "warp2template.txt").write_text(IDENTITY_ITK)
    sdd, delx = 1020.0, 0.194 * 1436 / det
    proj = Projector.from_volume(read(sub / "volume.nii.gz", device=dev), sdd=sdd, height=det,
                                 delx=delx)
    rot, xyz = (torch.tensor([p[i] for p in WORKFLOW_POSES], device=dev) for i in (0, 1))
    poses = convert(rot, xyz, "euler_angles", "ZXY", degrees=True)
    xrays = []
    for i in range(len(WORKFLOW_POSES)):
        pose = poses[i : i + 1]
        with torch.no_grad():
            d = proj.with_shearwarp(pose, differentiable=False)(pose)[0, 0].double().cpu().numpy()
        intensity = 2.0 * np.exp(-np.log(2.0) * d / d.max()) - 1.0
        xrays.append(sub / "xrays" / f"{i:03d}.dcm")
        dcmwrite(xrays[-1], np.rint(intensity * 60000).astype(np.uint16), sdd=sdd,
                 row_spacing=delx, col_spacing=delx)
        stored = mapper @ pose.matrix.cpu().numpy()  # read_true applies it again
        conv._save_pose(xrays[-1].with_suffix(".npz"), stored, sdd, delx, delx, 0.0, 0.0, det, det)
    synthetic_checkpoint(root / "models" / "deepfluoro" / "finetuned" / name / "0001.ckpt",
                         poses, xrays, crop=100, device=dev, linearize=True)
    return poses.matrix.cpu().numpy()


def shell_commands(text: str) -> list:
    """The command lines of a shell script: continuations joined, comments
    and blank lines dropped, whitespace normalized."""
    lines = (" ".join(line.split()) for line in text.replace("\\\n", " ").splitlines())
    return [line for line in lines if line and not line.startswith("#")]


def shell_defaults(text: str) -> dict:
    """A shell script's ``VAR=${VAR:-default}`` defaults."""
    import re

    return dict(re.findall(r"^(\w+)=\$\{\1:-([^}]*)\}$", "\n".join(shell_commands(text)), re.M))


def expand(line: str, env) -> list:
    """A command line with its shell variables set from ``env``, as tokens."""
    import re
    import shlex

    return shlex.split(re.sub(r"\$\{?(\w+)\}?", lambda m: env[m.group(1)], line))


def evaluator_mtre(pose, gt, fids) -> float:
    """mTRE (mm) as the evaluator (and its CSV) defines it, in float64: the
    mean distance between the fiducials carried by ``pose`` and by ``gt``.
    A rotation error counts with the lever arm of the pose's translation
    (the source distance), where fiducial_mtre's counts with the fiducials'
    distance from the origin."""
    import numpy as np

    P, G = (np.asarray(m, np.float64).reshape(4, 4) for m in (pose, gt))
    return float(np.linalg.norm(fids @ (P[:3, :3] - G[:3, :3]).T + (P[:3, 3] - G[:3, 3]),
                                axis=-1).mean())


def pose_error(pose, gt) -> dict:
    """The rotation (degrees) and translation (mm) that take ``gt`` to
    ``pose``, and the shift of the source (the pose's camera centre, mm)."""
    import numpy as np

    P, G = (np.asarray(m, np.float64).reshape(4, 4) for m in (pose, gt))
    dR = P[:3, :3] @ G[:3, :3].T
    angle = np.degrees(np.arccos(np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)))
    return dict(rot_deg=float(angle), source_mm=float(np.linalg.norm(P[:3, 3] - G[:3, 3])))


def objective_at(reg, xray, poses) -> list:
    """The registrar's similarity at its fine stage (the masked render
    against the preprocessed X-ray, as the last stage scores it) at each of
    ``poses`` (4, 4) matrices."""
    import torch
    from xvr_tpu_torch.geometry import RigidTransform
    from xvr_tpu_torch.metrics.ncc import make_imagesim
    from xvr_tpu_torch.registrar.base import _parse_scales

    gt_img = torch.as_tensor(reg.initialize_pose(str(xray))[0], device=reg.device)
    scale = _parse_scales(reg.scales, reg.crop, gt_img.shape[-2])[-1]
    proj = reg.projector.rescale_detector(scale)
    _, transform = reg._make_stage(proj, 1, 9, 11, 0.0, 0.5)
    sim = make_imagesim(9, 11, 0.0, 0.5)
    prepared = proj.prepare()
    out = []
    with torch.no_grad():
        for m in poses:
            pose = RigidTransform(torch.as_tensor(m, dtype=torch.float32, device=reg.device).reshape(1, 4, 4))
            img = proj(pose, density=proj.density, prepared=prepared)
            out.append(float(sim(transform(gt_img), transform(img))[0]))
    return out


def read_csv(path):
    lines = Path(path).read_text().strip().splitlines()
    return [dict(zip(lines[0].split(","), line.split(","))) for line in lines[1:]]


def phase_workflows(workdir: Path, hu, aff, fids, card, dev="cuda", kernels=REGISTER_SW, det=1436):
    """The published DeepFluoro runs of scripts/torch, in process, on one
    subject (write_deepfluoro_subject; two X-rays of the whole CT, the only
    cut): the xvr-torch line of deepfluoro/register/finetuned.sh (1436^2
    cropped by 100, --linearize, -m mask --labels 1,2,3,4,7, scales 24,12,6
    x 500) with the launch counts of its run, its final mTRE held < 1 mm,
    and the registrar's objective at the GT and the final poses; the loop of
    deepfluoro/evaluate/finetuned.sh (register model --warp --init_only,
    then its evaluate line); evaluate.py on the register run's tree;
    validate_convention.py with --crop 100. ``kernels=()`` skips the launch
    checks (a rehearsal on the CPU). Times are tagged with ``card``.
    -> (launches of the register run, stats)."""
    import contextlib
    import io
    import re

    import numpy as np
    import torch
    from xvr_tpu_torch.render.volume import transform_hu_to_density

    root = workdir / "workflows"
    name = "subject01"
    t0 = time.perf_counter()
    shares = deepfluoro_mask(hu)[1]
    gt = write_deepfluoro_subject(root, name, hu, aff, fids, dev, det)
    n_x = len(WORKFLOW_POSES)
    femur = shares[5] + shares[6]
    log(f"workflows: DeepFluoro {name} of the bench CT, {n_x} X-rays of {det}^2 of the whole CT, "
        f"labels' bone shares {json.dumps(shares)} (femurs 5+6: {femur:.4f} < {FEMUR_SHARE_MAX}), "
        f"written in {time.perf_counter() - t0:.1f} s")
    if not (0.0 < shares[5] and 0.0 < shares[6] and femur < FEMUR_SHARE_MAX):
        raise AssertionError(f"the femur boxes hold {femur:.4f} of the bone, not (0, {FEMUR_SHARE_MAX})")
    fids = np.asarray(fids, np.float32).astype(np.float64)  # as fiducials.npy holds them
    device = [] if dev == "cuda" else ["--device", dev]
    ev, vc = _load_script("evaluate"), _load_script("validate_convention")
    walls = {}
    cwd = os.getcwd()
    os.chdir(root)
    try:
        # 1. register/finetuned.sh's xvr-torch line, its flags as published
        text = (REPO / "scripts" / "torch" / "deepfluoro" / "register" / "finetuned.sh").read_text()
        (line,) = [x for x in shell_commands(text) if x.startswith("xvr-torch ")]
        argv = expand(line, {**shell_defaults(text), "SUBJECT": name})[1:]
        reg, launches, walls["register"] = cli_run(
            f"workflows: register/finetuned.sh SUBJECT={name}", argv + device, kernels,
            bundles=n_x, renderer="trilinear_fast" if kernels else None)
        # --labels: the density the shear-warp path packs is the masked one
        masked = transform_hu_to_density(torch.as_tensor(masked_hu(hu), device=dev))
        packed = reg.projector.prepare_for_shearwarp()
        masked_ok = bool(torch.equal(reg.projector.density, masked)
                         and torch.equal(packed, reg.projector.prepare_for_shearwarp(masked))
                         and not torch.equal(packed, reg.projector.prepare_for_shearwarp(
                             transform_hu_to_density(torch.as_tensor(hu, device=dev)))))
        out = Path(argv[argv.index("-o") + 1])
        bundles = [np.load(out / f"{i:03d}" / "parameters.npz") for i in range(n_x)]
        mtre, emtre = ({k: [f(b[k], g, fids) for b, g in zip(bundles, gt)]
                        for k in ("init_pose", "final_pose")} for f in (fiducial_mtre, evaluator_mtre))
        errors = [pose_error(b["final_pose"], g) for b, g in zip(bundles, gt)]
        # the objective the registration climbs, at GT and at its end
        xrays = sorted(Path(argv[2]).glob("*.dcm"))  # register model <xrays> ...
        objective = [dict(zip(("gt", "final"), objective_at(reg, xray, (g, b["final_pose"]))))
                     for xray, b, g in zip(xrays, bundles, gt)]
        log(f"workflows: mTRE {[round(m, 4) for m in mtre['init_pose']]} -> "
            f"{[round(m, 4) for m in mtre['final_pose']]} mm (phase 5's: the fiducials through "
            f"each pose's inverse); the evaluator's (the fiducials through each pose) "
            f"{[round(m, 4) for m in emtre['init_pose']]} -> "
            f"{[round(m, 4) for m in emtre['final_pose']]} mm; final pose off GT by "
            f"{json.dumps(errors)}; the registrar's fine-stage objective at GT and final "
            f"{json.dumps(objective)}")
        log(f"workflows: the density packed for K1 is the masked one: {masked_ok}")

        # 2. evaluate/finetuned.sh: register model --warp --init_only, then its evaluate line
        text = (REPO / "scripts" / "torch" / "deepfluoro" / "evaluate" / "finetuned.sh").read_text()
        env = shell_defaults(text)
        (sweep,) = [x for x in shell_commands(text) if x.startswith("xvr-torch ")]
        (score,) = [x for x in shell_commands(text) if x.startswith("python scripts/torch/evaluate.py")]
        walls["init_only"] = []
        for subj in sorted(Path("data/deepfluoro").glob("subject*/")):
            for ckpt in sorted(Path(env["CKPTDIR"], subj.name).glob("*.ckpt")):
                env.update(SUBJECT=subj.name, CKPTPATH=str(ckpt), CKPT_IDX=ckpt.stem)
                _, _, wall = cli_run(f"workflows: evaluate/finetuned.sh {ckpt}",
                                     expand(sweep, env)[1:] + device, (), bundles=n_x)
                walls["init_only"].append(wall)
        sweep_argv = expand(sweep, env)
        sweep_root = Path(sweep_argv[sweep_argv.index("-o") + 1]).parents[1]
        same_init = all(np.array_equal(np.load(sweep_root / name / "0001" / f"{i:03d}" /
                                               "parameters.npz")["init_pose"], b["init_pose"])
                        for i, b in enumerate(bundles))
        tokens = expand(score, env)
        t1 = time.perf_counter()
        if tokens[:2] != ["python", "scripts/torch/evaluate.py"] or ev.main(tokens[2:] + device):
            raise AssertionError(f"workflows: {score} failed")
        walls["evaluate_init_only"] = time.perf_counter() - t1
        sweep_rows = read_csv(tokens[tokens.index("-s") + 1])

        # 3. the register run's tree, scored
        register_root = out.parent
        csv = register_root.parent / f"{register_root.name}.csv"
        t1 = time.perf_counter()
        if ev.main(["-f", str(register_root), "-s", str(csv), "-d", "data", *device]):
            raise AssertionError("workflows: evaluate.py on the register results failed")
        walls["evaluate_register"] = time.perf_counter() - t1
        rows = {(r["subject"], r["xray"]): r for r in read_csv(csv)}

        # 4. validate_convention.py
        t1 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = vc.main(["data", "deepfluoro", "-s", name, "--crop", "100", *device])
        walls["validate"] = time.perf_counter() - t1
        mncc = [float(v) for v in re.findall(r"mNCC=([-+0-9.]+)", buf.getvalue())]
    finally:
        os.chdir(cwd)
    log("\n".join(f"  validate: {line}" for line in buf.getvalue().strip().splitlines()))

    csv_err = [abs(float(rows[(name, f"{i:03d}")][col]) - m)
               for col, key in (("mtre_init", "init_pose"), ("mtre", "final_pose"))
               for i, m in enumerate(emtre[key])] if len(rows) == n_x else [float("inf")]
    expect = {(name, "0001", f"{i:03d}") for i in range(n_x)}
    sweep_ok = (len(sweep_rows) == len(expect)
                and {(r["subject"], r["epoch"], r["xray"]) for r in sweep_rows} == expect
                and all(r["dataset"] == "deepfluoro" and r["mtre_init"] and not r.get("mtre")
                        for r in sweep_rows))
    stats = dict(card=card, cut="two X-rays of one subject", bone_shares=shares, walls_s=walls,
                 mtre_init_mm=mtre["init_pose"], mtre_final_mm=mtre["final_pose"],
                 evaluator_mtre_init_mm=emtre["init_pose"], evaluator_mtre_final_mm=emtre["final_pose"],
                 final_error=errors, objective=objective,
                 launches={k: launches[k] for k in SW_KERNELS},
                 csv_rows=dict(register=len(rows), init_only=len(sweep_rows)),
                 csv_mtre_err_mm=max(csv_err), validate_mncc=mncc, validate_rc=rc,
                 masked_density_packed=masked_ok, warp_identity_init_bit_identical=same_init)
    log(f"workflows: register {walls['register']:.2f} s, --init_only "
        f"{[round(w, 2) for w in walls['init_only']]} s, evaluate {walls['evaluate_init_only']:.2f} / "
        f"{walls['evaluate_register']:.2f} s, validate {walls['validate']:.2f} s; CSV rows {len(rows)} "
        f"(register) and {len(sweep_rows)} (init-only, {len(expect)} expected); CSV mtre and "
        f"mtre_init vs the registrar's poses' max |diff| {max(csv_err):.2e} mm (<= {CSV_MTRE_ATOL}); "
        f"--warp identity leaves the init pose bit for bit: {same_init}; validate exit {rc}, "
        f"mNCC {mncc} [{card}]")
    print("workflows " + json.dumps(stats), flush=True)
    print(card, flush=True)
    failed = [what for what, bad in (
        ("a final mTRE >= 1 mm", not max(mtre["final_pose"]) < 1.0),
        (f"the CSV's mTRE off the registrar's by > {CSV_MTRE_ATOL} mm", not max(csv_err) <= CSV_MTRE_ATOL),
        ("the init-only CSV lacks a row for an X-ray x checkpoint", not sweep_ok),
        ("validate_convention exited non-zero", rc != 0 or len(mncc) != n_x),
        ("the registration packed the unmasked density", not masked_ok),
        ("--warp identity moved the init pose", not same_init)) if bad]
    if failed:
        raise AssertionError(f"workflows: {failed}")
    return launches, stats


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


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
    rays_records, rays_calls = phase_rays_adjoint(sw_proj, pose16, pose4)
    records.update(rays_records)
    for calls, more in zip(sw_calls, rays_calls):
        calls.update(more)
    edge_errs = phase_edge_kernels(sw_proj.prepare_for_shearwarp())
    edge_errs.update(phase_edge_slab())
    slab_records, slab_calls = phase_slab_kernels(slab_proj, pose16, pose4, vol.mask)
    records.update(slab_records)
    trainer = phase_trainer_shape(vol)
    trainer_sw = phase_trainer_shearwarp(hu, aff)
    workflow_errs = phase_workflow_kernels(hu, aff)
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
    boxes_bench = check_content_boxes(sw_proj.prepare_for_shearwarp(), "bench volume")
    log(f"kernels: all checks passed ({time.perf_counter() - t0:.1f} s)")

    # 4. the slices, each with the launch counts of its own run
    with tempfile.TemporaryDirectory(prefix="xvr_chip_smoke_") as tmp:
        workdir = Path(tmp)
        gt_pose, gt_proj, gt_img = write_scene(workdir, hu, aff)
        sw_launches, sw_stats = register(workdir, gt_pose, fids, "trilinear_fast", REGISTER_SW)
        slab_launches, slab_stats = register(workdir, gt_pose, fids, "trilinear_pallas",
                                             REGISTER_SLAB, no_shearwarp=True)
        # 5. the entry points, in the same scene
        entry_launches, entry_stats = phase_entry_points(workdir, gt_pose, fids, smi)
        # 6. training: train masked and unmasked, and restart, through the CLI
        train_stats = phase_training(workdir, hu, aff, smi)
        # 7. the rest: the device mesh, the lean scan, animate and dcm2nii
        rest_stats = phase_rest(workdir, proj, sw_proj, pose4, gt_pose, fids, smi)
        # 8. the dataset workflows: scripts/torch's DeepFluoro register and evaluate runs
        wf_launches, wf_stats = phase_workflows(workdir, hu, aff, fids, smi)
    render_launches, render_stats = label_and_siddon_renders(vol, gt_pose, gt_proj, gt_img, pose4)
    launches = {**{k: sw_launches[k] for k in REGISTER_SW},
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
        rec["launches_workflows"] = wf_launches[name]
        if name in REGISTER_SW:
            rec["launches_register_model"] = entry_launches[name]
        rec["max_abs_err"] = max([r["max_abs_err"] for r in recs] + [workflow_errs.get(name, 0.0)])
        if name in workflow_errs:
            rec["workflow_max_abs_err"] = workflow_errs[name]
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
        if name in REGISTER_SW:
            # phase 7's mesh paths, each counted over its own run
            rec["launches_sharded_registration"] = rest_stats["sharded_registration"]["launches"][name]
            rec["launches_sharded_train_step"] = rest_stats["sharded_training"]["launches_per_step"].get(
                name, 0)
        if name in trainer_sw:
            rec["trainer"] = trainer_sw[name]
            rec["launches_train_step"] = {k: train_stats[k]["launches_per_step"].get(name, 0)
                                          for k in ("masked", "unmasked")}
        kernels.append(rec)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print("slices " + json.dumps({"shearwarp": sw_stats, "slab": slab_stats, "renders": render_stats}),
          flush=True)
    print("entry " + json.dumps({**entry_stats, "model_launches": entry_launches}), flush=True)
    print("train " + json.dumps(train_stats), flush=True)
    print("rest " + json.dumps(rest_stats), flush=True)
    print("content_boxes " + json.dumps(dict(
        bench_volume=boxes_bench, trainer_stack=trainer_sw["sw_content_boxes"]["masked"],
        launches=launches["sw_content_boxes"], launches_register_model=entry_launches[
            "sw_content_boxes"], launches_workflows=wf_launches["sw_content_boxes"],
        launches_train_step={k: train_stats[k]["launches_per_step"].get("sw_content_boxes", 0)
                             for k in ("masked", "unmasked")})), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
