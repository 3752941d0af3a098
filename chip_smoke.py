#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the hand-written shear-warp kernels from ``xvr_tpu_torch/csrc``, holds
each kernel against its plain PyTorch version at the shapes of the
registration path, then drives that path once through its user entry point,
``xvr_tpu_torch.registrar.RegistrarFixed(...).run(xray)``, on the bench
scene: a 256^3 CT (384 mm extent, 1.5 mm voxels) and a 1436^2 DICOM X-ray
(sdd 1020, 0.194 mm pixels, crop 100), scales 24,12,6 with a 16-seed coarse
sweep, 4 restart seeds and one re-anneal, from a ~4 mm initial error.

Phases (each prints one or more lines; any failure exits non-zero):

1. device   card name and power limit (nvidia-smi)
2. build    nvcc seconds and the -Xptxas -v report
3. kernels  K1-K4 against their plain versions: max error and tolerance,
            kernel / plain / library times (CUDA events) and the bound
4. slice    GT render, registration, launches of K1-K4 during it, mTRE

The line before the last is one JSON object with a record per kernel; the
last line is ``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
SOURCE = "xvr_tpu_torch/csrc/shearwarp.cu"
REPLACES = {
    "sw_accumulate": "xvr_tpu/render/shearwarp.py:222",
    "sw_warp": "xvr_tpu/render/shearwarp.py:368",
    "sw_warp_grads": "xvr_tpu/render/shearwarp.py:400",
    "sw_accumulate_adjoint": "xvr_tpu/render/shearwarp.py:955",
}


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
    ok = bool(torch.isfinite(got).all()) and bool((diff <= atol + rtol * ref.abs()).all())
    log(f"  {name} {label}: max_abs_err={err:.3e} tol=atol {atol:.3e} + rtol {rtol:g}*|ref| "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {label}: outside tolerance (max abs error {err})")
    return err


def phase_kernels(projector, pose16, pose4, time_ms=cuda_time_ms):
    """K1-K4 against their plain versions at the path's shapes.

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
    from xvr_tpu_torch.registrar.base import _parse_scales
    from xvr_tpu_torch.render import _cuda
    from xvr_tpu_torch.render import shearwarp as sw

    vol = projector.prepare_for_shearwarp()
    M, Wd, L = vol.shape
    records = {}
    s_coarse, _, s_fine = _parse_scales("24,12,6", 100, projector.detector.height)
    cases = [("coarse B=16", pose16, s_coarse), ("fine B=4", pose4, s_fine)]

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
            log(f"    vs JAX bf16 recipe: {float((k1 - sw._accumulate(vol, *args, **kw)).abs().max()):.3e}")
            # K4 on the cotangent image of a random detector cotangent
            ibar = sw._warp_transpose(x["g"] * x["ws"], x["uc"], x["vc"], grid_shape=(Iu, Iv))
            k4 = sw.accumulate_adjoint(vol, *args, ibar, **kw)
            r4 = sw._accumulate_adjoint(vol, *args, ibar, bf16=False, **kw)
            e4 = check("K4 sw_accumulate_adjoint", k4, r4, tag, 1e-4 * float(r4.abs().max()), 1e-3)
            log(f"    vs JAX bf16 recipe: {float((k4 - sw._accumulate_adjoint(vol, *args, ibar, **kw)).abs().max()):.3e}")
            if eps != 1.0:
                continue
            I64, w64 = k1.double(), f64(*warp_args)
            k2 = sw.warp(k1, *warp_args)
            r2 = sw._warp_plain(I64, *w64, bf16=False)
            e2 = check("K2 sw_warp", k2.double(), r2, tag, 1e-5 * float(r2.abs().max()))
            k3 = sw.warp_with_grads(k1, *warp_args)
            r3 = sw._warp_with_grads_plain(I64, *w64, bf16=False)
            e3 = max(check(f"K3 sw_warp_grads[{o}]", a.double(), b, tag, 1e-5 * float(I64.abs().max()))
                     for o, (a, b) in enumerate(zip(k3, r3)))

            # times at this shape (eps 1.0)
            reps = 20
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
            # library yardstick for the warps: grid_sample on the same image
            gx = (x["vc"] / (Iv - 1)) * 2 - 1
            gy = (x["uc"] / (Iu - 1)) * 2 - 1
            grid_n = torch.stack([gx, gy], -1).reshape(B, 1, R, 2)
            img = k1[:, None]
            lib = time_ms(lambda: F.grid_sample(img, grid_n, mode="bilinear",
                                                     align_corners=True), reps)
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
                    name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
                    launches=0, max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                    bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                    library_ms=lib_ms, shape=f"B={B} grid={Iu}x{Iv} det={det[0]}x{det[1]} eps={eps}",
                )
                log(f"  time {name} [{rec['shape']}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"library {lib_ms if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
                    f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}: {nbytes / 1e6:.1f} MB, "
                    f"{nops / 1e9:.3f} GFLOP)")
                records.setdefault(name, []).append(rec)
    _cuda.reset_launches()
    return records


# ---------------------------------------------------------------------------
# phase 4: the registration slice
# ---------------------------------------------------------------------------


def phase_slice(workdir: Path, hu, aff, fids, dev="cuda", det=1436):
    """Render the GT X-ray, then register it with the bench's configuration.
    ``dev`` and ``det`` let the control flow be rehearsed on the CPU at a
    small detector."""
    import numpy as np
    import torch
    from xvr_tpu_torch.geometry import convert
    from xvr_tpu_torch.io import dcmwrite, read, save_nifti
    from xvr_tpu_torch.registrar import RegistrarFixed
    from xvr_tpu_torch.render import Projector
    from xvr_tpu_torch.render import _cuda
    from xvr_tpu_torch.render import xla

    SDD, H, DELX = 1020.0, det, 0.194 * 1436 / det

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

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
    log(f"slice: phantom CT + {H}^2 GT X-ray ({gt_proj.renderer}) written in "
        f"{time.perf_counter() - t0:.1f} s")

    # the fast render agrees with the golden renderer on a small detector
    # (the JAX package's bound: max error < 2% of max, correlation > 0.9999)
    small = gt_proj.rescale_detector(H / 96)
    with torch.no_grad():
        fast = small.replace(renderer="trilinear_fast")(gt_pose)
        src, tgt = small.rays(gt_pose)
        gold = xla.raymarch_trilinear(small.density, small.affine_inverse, src, tgt,
                                      n_samples=512).reshape(fast.shape)
    rel = float((fast - gold).abs().max() / gold.abs().max())
    corr = float(np.corrcoef(fast.cpu().numpy().ravel(), gold.cpu().numpy().ravel())[0, 1])
    log(f"slice: fast vs golden render at 96^2: max rel err {rel:.4f} (< 0.02), corr {corr:.6f} (> 0.9999)")
    if not (rel < 0.02 and corr > 0.9999):
        raise AssertionError("fast render disagrees with the golden renderer")

    gt_np = gt_pose.matrix[0].cpu().numpy()
    rot0, xyz0 = gt_pose.convert("euler_angles", "ZXY")
    rot_init = (rot0[0].cpu().numpy() + np.deg2rad([0.6, -0.5, 0.4])).tolist()
    xyz_init = (xyz0[0].cpu().numpy() + np.array([2.0, -3.0, 1.5])).tolist()
    reg = RegistrarFixed(
        volume=workdir / "ct.nii.gz", mask=None, orientation="AP",
        rot=rot_init, xyz=xyz_init,
        linearize=False, scales="24,12,6", n_itrs="500,500,500", crop=100,
        reverse_x_axis=False, lr_rot=1e-2, lr_xyz=1.0,
        patience=10, max_n_plateaus=3, verbose=1, coarse_seeds=16, device=dev,
    )
    _cuda.reset_launches()
    sync()
    t0 = time.perf_counter()
    out = reg.run(workdir / "xray.dcm")
    sync()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    log(f"slice: renderer {reg.projector.renderer}, wall {wall:.2f} s, "
        f"launches {json.dumps(launches)}")
    for rec in reg.stage_log:
        log(f"  stage {rec['stage']} K={rec['K']} {rec['height']}x{rec['width']}: "
            f"{rec['n_done']} itrs, {rec['ms_per_itr']:.2f} ms/itr")
    m_init = fiducial_mtre(out[3].matrix.cpu().numpy(), gt_np, fids)
    m_final = fiducial_mtre(out[4].matrix.cpu().numpy(), gt_np, fids)
    log(f"slice: mTRE init {m_init:.3f} mm -> final {m_final:.3f} mm (< 1 mm)")
    if reg.projector.renderer != "trilinear_fast":
        raise AssertionError(f"registration ran {reg.projector.renderer}, not trilinear_fast")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    if not m_final < 1.0:
        raise AssertionError(f"final mTRE {m_final:.3f} mm >= 1 mm")
    return launches, dict(wall_s=wall, mtre_init_mm=m_init, mtre_final_mm=m_final)


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

    # 3. kernels at the path's shapes, on the bench scene
    import numpy as np
    from xvr_tpu_torch.geometry import convert
    from xvr_tpu_torch.render import Projector, Volume

    t0 = time.perf_counter()
    hu, aff, fids = build_phantom(256)
    log(f"phantom: 256^3 built in {time.perf_counter() - t0:.1f} s")
    vol = Volume(data=torch.as_tensor(hu, device="cuda"), affine=torch.as_tensor(aff, device="cuda"))
    proj = Projector.from_volume(vol, sdd=1020.0, height=1336, delx=0.194)
    rng = np.random.default_rng(3)

    def poses(n):
        rot = np.deg2rad([182.0, -4.0, 3.0]) + np.deg2rad(rng.uniform(-3, 3, (n, 3)))
        xyz = np.array([6.0, 740.0, -10.0]) + rng.uniform(-10, 10, (n, 3))
        return convert(torch.tensor(rot, dtype=torch.float32, device="cuda"),
                       torch.tensor(xyz, dtype=torch.float32, device="cuda"), "euler_angles", "ZXY")

    pose16, pose4 = poses(16), poses(4)
    proj = proj.with_shearwarp(pose16[:1])
    log(f"kernels: volume perm {proj.pallas_perm}, renderer {proj.renderer}")
    records = phase_kernels(proj, pose16, pose4)
    log(f"kernels: all checks passed ({time.perf_counter() - t0:.1f} s)")

    with tempfile.TemporaryDirectory(prefix="xvr_chip_smoke_") as tmp:
        launches, slice_stats = phase_slice(Path(tmp), hu, aff, fids)

    # one record per kernel: the fine stage's shape (B=4, 256^2 grid, eps 1)
    kernels = []
    for name, recs in records.items():
        rec = dict(recs[-1])
        rec["launches"] = launches[name]
        rec["max_abs_err"] = max(r["max_abs_err"] for r in recs)
        kernels.append(rec)
    log(f"total: {time.perf_counter() - t_start:.1f} s; slice {json.dumps(slice_stats)}")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
