#!/usr/bin/env python3
"""mTRE of the port's registration over seeded inits, on one GPU.

Registers the bench scene of ``chip_smoke.py`` (the 256^3 phantom CT and the
1436^2 shear-warp DRR of its ground-truth pose) with ``RegistrarFixed`` in
the bench's configuration, from the bench's ~4 mm init and from ``--inits``
more, drawn from a fixed seed: rotations uniform in +-0.8 degrees and
translations in +-4 mm per axis about the ground truth. The registration
renders through shear-warp (``trilinear_fast``, K1-K4), or with ``--slab``
under XVR_NO_SHEARWARP=1 through the slab kernels (``trilinear_pallas``, K5
and K6). ``--k4`` chooses what computes the source adjoint (K4) in the
backward pass of every shear-warp render:

  kernel    the port's own kernel, ``sw_accumulate_adjoint``
  plain32   its plain PyTorch version on the card, in float32
  plain64   the same in float64 (positions and sums)
  DIR       the K4 kernel of another checkout of the repository at DIR, built
            from that checkout's sources (for example an unpacked parent commit)

``--port DIR`` imports the port (``xvr_tpu_torch``) from another checkout,
whose kernels then render the scene and run the registration.

Prints one line per registration and, last, one JSON object with every
record; ``--out`` writes that object to a file as well.

Usage: python3 scripts/chip_mtre_spread.py [--slab] [--port DIR] [--k4 MODE] [--inits N]
                                           [--out FILE]
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BENCH_INIT = ((0.6, -0.5, 0.4), (2.0, -3.0, 1.5))  # degrees, mm: chip_smoke.py's init
SEED = 11  # of the seeded inits


def load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def route_k4(mode: str) -> None:
    """Make the fast render's backward compute K4 as ``mode`` says."""
    import torch
    from xvr_tpu_torch.render import shearwarp as sw

    if mode == "kernel":
        return
    if mode in ("plain32", "plain64"):
        dt = torch.float32 if mode == "plain32" else torch.float64

        def plain(vol, s_p, sgn, u0, du, v0, dv, Ibar, boxes=None, **kw):
            args = [x.to(dt) for x in (s_p, sgn, u0, du, v0, dv)]
            return sw._accumulate_adjoint(vol, *args, Ibar, bf16=False, **kw).to(s_p.dtype)

        sw.accumulate_adjoint = plain
        return
    other = Path(mode).resolve() / "xvr_tpu_torch" / "render" / "_cuda.py"
    if not other.is_file():
        raise SystemExit(f"--k4 {mode}: no checkout of the port there")
    k4 = load_module("k4_checkout_cuda", other).accumulate_adjoint
    if "boxes" in inspect.signature(k4).parameters:
        sw._cuda.accumulate_adjoint = k4
    else:  # a checkout from before the content skip: its K4 marches every slab
        sw._cuda.accumulate_adjoint = lambda vol, params, ibar, boxes, **kw: k4(vol, params, ibar, **kw)


def register(smoke, workdir: Path, gt_pose, fids, d_rot_deg, d_xyz, renderer: str) -> dict:
    import numpy as np
    import torch
    from xvr_tpu_torch.registrar import RegistrarFixed
    from xvr_tpu_torch.render import _cuda

    rot0, xyz0 = gt_pose.convert("euler_angles", "ZXY")
    reg = RegistrarFixed(
        volume=workdir / "ct.nii.gz", mask=None, orientation="AP",
        rot=(rot0[0].cpu().numpy() + np.deg2rad(d_rot_deg)).tolist(),
        xyz=(xyz0[0].cpu().numpy() + np.asarray(d_xyz)).tolist(),
        linearize=False, scales="24,12,6", n_itrs="500,500,500", crop=100,
        reverse_x_axis=False, lr_rot=1e-2, lr_xyz=1.0,
        patience=10, max_n_plateaus=3, verbose=1, coarse_seeds=16, device="cuda",
    )
    _cuda.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = reg.run(workdir / "xray.dcm")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if reg.projector.renderer != renderer:
        raise AssertionError(f"registration ran {reg.projector.renderer}, not {renderer}")
    kernels = "slab_" if renderer == "trilinear_pallas" else "sw_"
    gt = gt_pose.matrix[0].cpu().numpy()
    return dict(
        d_rot_deg=[float(x) for x in d_rot_deg], d_xyz=[float(x) for x in d_xyz], wall_s=wall,
        mtre_init_mm=smoke.fiducial_mtre(out[3].matrix.cpu().numpy(), gt, fids),
        mtre_final_mm=smoke.fiducial_mtre(out[4].matrix.cpu().numpy(), gt, fids),
        launches={k: v for k, v in _cuda.LAUNCHES.items() if k.startswith(kernels)},
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", default=str(REPO), help="checkout to import xvr_tpu_torch from")
    ap.add_argument("--slab", action="store_true",
                    help="register through the slab kernels (XVR_NO_SHEARWARP=1)")
    ap.add_argument("--k4", default="kernel", help="kernel, plain32, plain64 or a checkout")
    ap.add_argument("--inits", type=int, default=16, help="seeded inits beside the bench's")
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_mtre_spread: no CUDA device", file=sys.stderr)
        return 2
    port = Path(opts.port).resolve()
    sys.path.insert(0, str(port))
    smoke = load_module("chip_smoke_helpers", REPO / "chip_smoke.py")
    if opts.slab and opts.k4 != "kernel":
        raise SystemExit("--k4 swaps a kernel of the shear-warp path; --slab does not run it")
    route_k4(opts.k4)
    renderer = "trilinear_pallas" if opts.slab else "trilinear_fast"
    if opts.slab:
        os.environ["XVR_NO_SHEARWARP"] = "1"
    smi = smoke.nvidia_smi()
    print(f"device: {smi} | port {port} | renderer {renderer} | K4 {opts.k4}", flush=True)

    rng = np.random.default_rng(SEED)
    inits = [BENCH_INIT] + [(rng.uniform(-0.8, 0.8, 3), rng.uniform(-4.0, 4.0, 3))
                            for _ in range(opts.inits)]
    hu, aff, fids = smoke.build_phantom(256)
    recs = []
    with tempfile.TemporaryDirectory(prefix="xvr_mtre_") as tmp:
        gt_pose, _, _ = smoke.write_scene(Path(tmp), hu, aff)
        for n, (d_rot, d_xyz) in enumerate(inits):
            rec = register(smoke, Path(tmp), gt_pose, fids, d_rot, d_xyz, renderer)
            recs.append(rec)
            print(f"init {n}: mTRE {rec['mtre_init_mm']:.3f} -> {rec['mtre_final_mm']:.4f} mm, "
                  f"wall {rec['wall_s']:.2f} s, launches {json.dumps(rec['launches'])}", flush=True)
    seeded = sorted(r["mtre_final_mm"] for r in recs[1:])
    summary = dict(
        device=smi, port=str(port), renderer=renderer, k4=opts.k4, seed=SEED,
        bench_final_mm=recs[0]["mtre_final_mm"],
        median_final_mm=float(np.median(seeded)) if seeded else None,
        max_final_mm=seeded[-1] if seeded else None, inits=recs,
    )
    line = json.dumps(summary)
    if opts.out:
        Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
