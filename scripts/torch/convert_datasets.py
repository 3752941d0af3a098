"""Convert the DeepFluoro / Ljubljana benchmark HDF5 files into the data
layout (DICOM X-rays + NIfTI volumes + ground-truth poses), on the PyTorch
port.

Counterpart of ``scripts/convert_datasets.py``, without JAX or click, through
``xvr_tpu_torch.io``'s ``dcmwrite`` and ``save_nifti``: reads the raw HDF5
files (``ipcai_2020_full_res_data.h5`` for DeepFluoro, ``ljubljana.h5``),
extracts projection intrinsics from the pinhole K matrices, writes 16-bit
MONOCHROME2 DICOMs with sdd/spacing/origin tags, saves the CT volumes
(flipped as the reference conversion flips them) as NIfTI, and stores
ground-truth poses + intrinsics as ``.npz`` files read by
scripts/torch/evaluate.py: the files the JAX script writes.
``h5py`` is imported by the converters only.

Usage:
    python scripts/torch/convert_datasets.py deepfluoro ipcai_2020_full_res_data.h5 -o data
    python scripts/torch/convert_datasets.py ljubljana ljubljana.h5 -o data
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

from xvr_tpu_torch.cli.commands.register import existing_path  # noqa: E402
from xvr_tpu_torch.io import dcmwrite, save_nifti  # noqa: E402

DEEPFLUORO_SUBJECTS = ["17-1882", "18-1109", "18-0725", "18-2799", "18-2800", "17-1905"]


def parse_intrinsics(intrinsic, rows, cols, row_spacing, col_spacing):
    """Pinhole K -> (sdd, detector origin offsets)."""
    fx = -intrinsic[0, 0] * col_spacing
    fy = -intrinsic[1, 1] * row_spacing
    assert abs(fx - fy) < 1e-3, "anisotropic focal lengths"
    sdd = float(fx)
    col_origin = -(cols / 2 - intrinsic[0, -1]) * col_spacing
    row_origin = -(rows / 2 - intrinsic[1, -1]) * row_spacing
    return sdd, float(row_origin), float(col_origin)


def _save_pose(path, pose, sdd, delx, dely, x0, y0, height, width):
    np.savez(
        path,
        pose=np.asarray(pose, dtype=np.float32),
        intrinsics_sdd=sdd, intrinsics_delx=delx, intrinsics_dely=dely,
        intrinsics_x0=x0, intrinsics_y0=y0,
        intrinsics_height=height, intrinsics_width=width,
    )


def convert_deepfluoro(h5path: Path, outroot: Path):
    import h5py

    with h5py.File(h5path, "r") as f:
        pp = f["proj-params"]
        intrinsic = pp["intrinsic"][:]
        cols = int(pp["num-cols"][()])
        rows = int(pp["num-rows"][()])
        col_spacing = float(pp["pixel-col-spacing"][()])
        row_spacing = float(pp["pixel-row-spacing"][()])
        sdd, row_origin, col_origin = parse_intrinsics(
            intrinsic, rows, cols, row_spacing, col_spacing
        )

        for idx, sid in enumerate(DEEPFLUORO_SUBJECTS, start=1):
            if sid not in f:  # partial files (e.g. test fixtures) are fine
                continue
            sub = f[sid]
            subject_dir = outroot / "deepfluoro" / f"subject{idx:02d}"
            xdir = subject_dir / "xrays"
            xdir.mkdir(parents=True, exist_ok=True)

            projs = sub["projections"]
            for name in projs:
                p = projs[name]
                img = p["image/pixels"][:].astype(np.uint16)
                if p["rot-180-for-up"][()]:
                    img = np.rot90(img, k=2).copy()
                dcmwrite(
                    xdir / f"{name}.dcm", img, sdd=sdd,
                    row_spacing=row_spacing, col_spacing=col_spacing,
                    row_origin=row_origin, col_origin=col_origin,
                )
                pose = np.asarray(p["gt-poses/cam-to-pelvis-vol"][:], dtype=np.float32)
                _save_pose(
                    xdir / f"{name}.npz", pose[None], sdd,
                    row_spacing, col_spacing, row_origin, col_origin, rows, cols,
                )

            # Volume: flip axes 0 and 1 like the reference conversion, so
            # that the NIfTI is consistent with the poses
            vol = sub["vol"]
            data = np.asarray(vol["pixels"][:], dtype=np.float32)
            spacing = np.asarray(vol["spacing"][:], dtype=np.float64).reshape(-1)
            origin = np.asarray(vol["origin"][:], dtype=np.float64).reshape(-1)
            # HDF5 pixels are (z, y, x); reorder to (x, y, z)
            data = np.transpose(data, (2, 1, 0))
            data = data[::-1, ::-1].copy()
            affine = np.diag([-spacing[0], -spacing[1], spacing[2], 1.0])
            affine[:3, 3] = origin
            save_nifti(subject_dir / "volume.nii.gz", data, affine)

            if "vol-seg" in sub:
                seg = np.transpose(
                    np.asarray(sub["vol-seg"]["image"]["pixels"][:], dtype=np.float32),
                    (2, 1, 0),
                )[::-1, ::-1].copy()
                save_nifti(subject_dir / "mask.nii.gz", seg, affine)

            if "anatomical-landmarks" in sub:
                fid = np.stack(
                    [np.asarray(sub["anatomical-landmarks"][k][:]).reshape(-1)
                     for k in sub["anatomical-landmarks"]]
                )
                np.save(subject_dir / "fiducials.npy", fid.astype(np.float32))
            print(f"deepfluoro subject{idx:02d}: {len(projs)} X-rays")


def convert_ljubljana(h5path: Path, outroot: Path):
    import h5py

    with h5py.File(h5path, "r") as f:
        for idx, sid in enumerate(sorted(f.keys()), start=1):
            sub = f[sid]
            subject_dir = outroot / "ljubljana" / f"subject{idx:02d}"
            xdir = subject_dir / "xrays"
            xdir.mkdir(parents=True, exist_ok=True)

            for key, name in [("proj-ap", "frontal"), ("proj-lat", "lateral"),
                              ("proj-ap-max", "frontal_max"), ("proj-lat-max", "lateral_max")]:
                if key not in sub:
                    continue
                p = sub[key]
                img = np.asarray(p["pixels"][:], dtype=np.float64)
                img = (img / img.max() * (2**16 - 1)).astype(np.uint16)
                rows, cols = img.shape
                intrinsic = p["intrinsic"][:]
                col_spacing = float(p["col-spacing"][()])
                row_spacing = float(p["row-spacing"][()])
                sdd, row_origin, col_origin = parse_intrinsics(
                    intrinsic, rows, cols, row_spacing, col_spacing
                )
                dcmwrite(
                    xdir / f"{name}.dcm", img, sdd=sdd,
                    row_spacing=row_spacing, col_spacing=col_spacing,
                    row_origin=row_origin, col_origin=col_origin,
                )
                if "gt-poses" in p or "extrinsic" in p:
                    ext = p["extrinsic"][:] if "extrinsic" in p else p["gt-poses"][:]
                    _save_pose(
                        xdir / f"{name}.npz", np.asarray(ext, np.float32)[None],
                        sdd, row_spacing, col_spacing, row_origin, col_origin, rows, cols,
                    )

            if "volume" in sub or "vol" in sub:
                vol = sub.get("volume", sub.get("vol"))
                data = np.asarray(vol["pixels"][:], dtype=np.float32)
                spacing = np.asarray(vol["spacing"][:], dtype=np.float64).reshape(-1)
                origin = np.asarray(vol["origin"][:], dtype=np.float64).reshape(-1)
                data = np.transpose(data, (2, 1, 0))
                data = data[::-1].copy()  # flip axis 0, as the reference conversion does
                affine = np.diag([-spacing[0], spacing[1], spacing[2], 1.0])
                affine[:3, 3] = origin
                save_nifti(subject_dir / "volume.nii.gz", data, affine)
            print(f"ljubljana subject{idx:02d} converted")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python scripts/torch/convert_datasets.py",
                                     description="Convert a benchmark HDF5 file to the data layout.")
    parser.add_argument("dataset", choices=["deepfluoro", "ljubljana"])
    parser.add_argument("h5path", type=existing_path)
    parser.add_argument("-o", "--outroot", type=str, default="data")
    return parser


def main(argv=None) -> int:
    kw = build_parser().parse_args(argv)
    outroot = Path(kw.outroot)
    if kw.dataset == "deepfluoro":
        convert_deepfluoro(Path(kw.h5path), outroot)
    else:
        convert_ljubljana(Path(kw.h5path), outroot)
    return 0


if __name__ == "__main__":
    sys.exit(main())
