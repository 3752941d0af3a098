"""Validate the pose convention against converted DeepFluoro/Ljubljana data,
on the PyTorch port.

Counterpart of ``scripts/validate_convention.py``, without JAX or click: for
each converted X-ray it renders the STORED ground-truth pose through the
port's renderer stack (the intrinsics plumbing of ``xvr-torch register``:
header intrinsics, the ``x0`` sign flip, the DeepFluoro axis-flip mapper of
``scripts/torch/evaluate.py``) and reports image similarity (mNCC /
gradient-NCC) between the rendered DRR and the paired X-ray. A correct
convention yields a high NCC; a flipped axis or a transposed rotation
collapses it.

Usage (after ``scripts/torch/convert_datasets.py``):
    python scripts/torch/validate_convention.py data deepfluoro            # all subjects
    python scripts/torch/validate_convention.py data deepfluoro -s subject01 -n 4

Exit code 1 when any X-ray falls below ``--threshold`` (default 0.4 mNCC:
real X-rays against DRRs land well above it when the geometry is right, and
near 0 when it is wrong).

Caveat, as for the JAX script: the check is weak against exactly one error
class, the ANTIPODAL pose (180 deg about the detector normal, e.g. a missing
DeepFluoro mapper flip), whose projection differs only by the cone beam's
magnification asymmetry. Catch that case by its mTRE in
``scripts/torch/evaluate.py``.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

from xvr_tpu_torch.cli.commands.register import existing_path  # noqa: E402


def _load_evaluate():
    spec = importlib.util.spec_from_file_location(
        "xvr_torch_evaluate", Path(__file__).resolve().parent / "evaluate.py"
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules["xvr_torch_evaluate"] = mod
    spec.loader.exec_module(mod)
    return mod


def validate_xray(volpath, maskpath, dcmpath, gt_pose, crop, linearize, size, device="cuda"):
    """-> dict of similarity figures for one (X-ray, stored-pose) pair."""
    import torch

    from xvr_tpu_torch.io import read_xray
    from xvr_tpu_torch.metrics import gradient_ncc, multiscale_ncc
    from xvr_tpu_torch.render.load import initialize_drr
    from xvr_tpu_torch.utils.transforms import make_xray_transforms

    gt, sdd, delx, dely, x0, y0, _ = read_xray(
        dcmpath, crop=crop, linearize=linearize
    )
    H, W = gt.shape[-2:]
    proj = initialize_drr(
        volpath, maskpath, None, "AP",
        height=H, width=W, sdd=sdd, delx=delx, dely=dely,
        x0=-x0, y0=y0,  # the reference's x0 sign flip, as the registrar applies it
        reverse_x_axis=False, renderer="trilinear", device=device,
    )
    # render at a pyramid scale (the full detector is wasteful for a yes/no
    # check); mNCC is computed on the matching downsampled pair
    scale = max(H, W) / float(size)
    proj_s = proj.rescale_detector(scale)
    h, w = proj_s.detector.height, proj_s.detector.width
    transform = make_xray_transforms(h, w, use_equalize=False)
    with torch.no_grad():
        pred = proj_s(gt_pose)
        a = transform(torch.as_tensor(gt, device=device))
        b = transform(pred)
        mncc = float(multiscale_ncc(a, b, (None, 9), (0.5, 0.5)).squeeze())
        gncc = float(gradient_ncc(a, b, 11, 10).squeeze())
    return {"mncc": mncc, "gncc": gncc, "render_hw": (h, w)}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python scripts/torch/validate_convention.py",
                                     description="Check the stored poses against the X-rays.")
    parser.add_argument("data_root", type=existing_path)
    parser.add_argument("dataset", choices=["deepfluoro", "ljubljana"])
    parser.add_argument("-s", "--subject", default=None, help="Restrict to one subject dir")
    parser.add_argument("-n", "--n-xrays", type=int, default=4,
                        help="X-rays checked per subject (default: 4)")
    parser.add_argument("--crop", type=int, default=0, help="Edge crop (px) (default: 0)")
    parser.add_argument("--linearize", action=argparse.BooleanOptionalAction, default=True,
                        help="Log-linearize the X-ray (real data: yes) (default: on)")
    parser.add_argument("--size", type=int, default=256,
                        help="Render/compare resolution, longest side (default: 256)")
    parser.add_argument("--threshold", type=float, default=0.4,
                        help="Minimum acceptable mNCC per X-ray (default: 0.4)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="Device to render on (cuda fails without a card)")
    return parser


def main(argv=None) -> int:
    kw = build_parser().parse_args(argv)
    if kw.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu)")
    ev = _load_evaluate()
    root = Path(kw.data_root) / kw.dataset
    subjects = [root / kw.subject] if kw.subject else sorted(
        p for p in root.iterdir() if (p / "xrays").is_dir()
    )
    failures, checked = [], 0
    for sub in subjects:
        vol = sub / "volume.nii.gz"
        mask = sub / "mask.nii.gz"
        npzs = sorted((sub / "xrays").glob("*.npz"))[: kw.n_xrays]
        for npz in npzs:
            dcm = npz.with_suffix(".dcm")
            if not dcm.exists():
                continue
            gt_pose, _ = ev.read_true(kw.dataset, sub.name, npz.stem, kw.data_root, kw.device)
            r = validate_xray(
                vol, mask if mask.exists() else None, dcm, gt_pose,
                kw.crop, kw.linearize, kw.size, kw.device,
            )
            checked += 1
            ok = r["mncc"] >= kw.threshold
            if not ok:
                failures.append((sub.name, npz.stem, r["mncc"]))
            print(
                f"{sub.name}/{npz.stem}: mNCC={r['mncc']:+.4f} "
                f"gNCC={r['gncc']:+.4f} @ {r['render_hw'][0]}x{r['render_hw'][1]}"
                f"  [{'ok' if ok else 'FAIL'}]",
                flush=True,
            )
    if checked == 0:
        print(f"Error: no (dcm, npz) pairs found under {root}", file=sys.stderr)
        return 1
    if failures:
        print(
            f"\nCONVENTION CHECK FAILED: {len(failures)}/{checked} X-rays "
            f"below mNCC {kw.threshold} — the stored poses do not reproduce the "
            "measured projections through this renderer stack.",
            flush=True,
        )
        return 1
    print(f"\nConvention check passed: {checked} X-rays >= mNCC {kw.threshold}.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
