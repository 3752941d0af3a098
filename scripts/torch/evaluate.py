"""Score saved registrations against ground-truth poses, on the PyTorch port.

Counterpart of ``scripts/evaluate.py``, without JAX or click: walk a results
tree for ``parameters.npz`` bundles (written by either package's
``register``), rebuild each dataset's ground-truth pose (with the DeepFluoro
axis-flip mapper), evaluate mPE/mRPE/mTRE/double-geodesic for the initial
and final poses with ``xvr_tpu_torch.metrics.Evaluator``, and write a CSV
with the same columns.

Ground truth layout (written by scripts/torch/convert_datasets.py):
  data/<dataset>/<subject>/volume.nii.gz [+ mask.nii.gz, fiducials.npy]
  data/<dataset>/<subject>/xrays/<xray>.npz  (keys: pose, intrinsics_*)
Results layout (written by `xvr-torch register`):
  <filepath>/.../<subject>/.../<xray>/parameters.npz

Usage:
    python scripts/torch/evaluate.py -f results/deepfluoro -s scores.csv -d data [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

from xvr_tpu_torch.cli.commands.register import existing_path  # noqa: E402


def initialize_evaluator(dataset, subject, intrinsics, data_root, voxel_shift=0.0, device="cuda"):
    import torch

    from xvr_tpu_torch.io.volumes import read
    from xvr_tpu_torch.metrics import Evaluator
    from xvr_tpu_torch.render.projector import Projector

    root = Path(data_root) / dataset / subject
    mask = root / "mask.nii.gz"
    vol = read(root / "volume.nii.gz", mask if mask.exists() else None, orientation="AP",
               device=device)
    proj = Projector.from_volume(
        vol,
        sdd=float(intrinsics["sdd"]),
        height=int(intrinsics["height"]),
        width=int(intrinsics["width"]),
        delx=float(intrinsics["delx"]),
        dely=float(intrinsics["dely"]),
        x0=float(intrinsics.get("x0", 0.0)),
        y0=float(intrinsics.get("y0", 0.0)),
        voxel_shift=voxel_shift,
    )
    fiducials = torch.as_tensor(np.load(root / "fiducials.npy"), device=device)
    if fiducials.ndim == 2:
        fiducials = fiducials[None]
    return Evaluator(proj, fiducials)


_DEEPFLUORO_MAPPER = np.diag([-1.0, -1.0, 1.0, 1.0]).astype(np.float32)


def read_true(dataset, subject, xray, data_root, device="cuda"):
    import torch

    from xvr_tpu_torch.geometry import RigidTransform

    f = np.load(Path(data_root) / dataset / subject / "xrays" / f"{xray}.npz")
    pose = np.asarray(f["pose"], dtype=np.float32)
    if pose.ndim == 2:
        pose = pose[None]
    if dataset == "deepfluoro":
        # the axis-flip mapper, applied after the recorded pose
        pose = _DEEPFLUORO_MAPPER @ pose
    intrinsics = {
        k.removeprefix("intrinsics_"): float(f[k])
        for k in f.files
        if k.startswith("intrinsics_")
    }
    return RigidTransform(torch.as_tensor(pose, device=device)), intrinsics


def read_pred(filename: Path, device="cuda"):
    import torch

    from xvr_tpu_torch.geometry import RigidTransform

    d = np.load(filename)
    init_pose = RigidTransform(torch.as_tensor(d["init_pose"], device=device))
    final_pose = ncc_init = ncc_final = runtime = None
    if "final_pose" in d.files:
        final_pose = RigidTransform(torch.as_tensor(d["final_pose"], device=device))
        ncc = d.get("trajectory_ncc")
        if ncc is not None and len(ncc):
            ncc_init, ncc_final = float(ncc[0]), float(ncc[-1])
        meta_path = filename.parent / "parameters.json"
        if meta_path.exists():
            runtime = json.loads(meta_path.read_text()).get("runtime")
    return init_pose, ncc_init, final_pose, ncc_final, runtime


DATASETS = ("deepfluoro", "ljubljana", "femur")


def process_filenames(filenames, results_root):
    """Infer (dataset, partition, subject, epoch, xray) from result paths.

    The dataset is the first of DATASETS among the parts below
    ``results_root``, else the nearest among the root's own parts: the
    evaluate scripts point ``-f`` at ``results/<dataset>/evaluate/<model>``,
    where the JAX script finds no dataset and scores nothing."""
    root_dataset = next((p for p in reversed(Path(results_root).resolve().parts)
                         if p in DATASETS), "unknown")
    rows = []
    for filename in filenames:
        rel = filename.parent.relative_to(results_root)
        parts = list(rel.parts)
        xray = parts[-1]
        subject = next((p for p in parts if p.startswith("subject")), parts[0])
        dataset = next((p for p in parts if p in DATASETS), root_dataset)
        sidx = parts.index(subject)
        partition = "-".join(parts[:sidx]) or "results"
        epoch = parts[sidx + 1] if len(parts) > sidx + 2 else None
        rows.append((filename, dataset, partition, subject, epoch, xray))
    return sorted(rows, key=lambda r: (r[1], r[3], r[5]))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python scripts/torch/evaluate.py",
                                     description="Score registration results to a CSV.")
    parser.add_argument("-f", "--filepath", type=existing_path, required=True)
    parser.add_argument("-s", "--savepath", type=str, required=True)
    parser.add_argument("-d", "--data-root", type=existing_path, default="data")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="Device to evaluate on (cuda fails without a card)")
    return parser


def main(argv=None) -> int:
    kw = build_parser().parse_args(argv)
    filepath, savepath, data_root, device = kw.filepath, kw.savepath, kw.data_root, kw.device
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu)")

    filenames = sorted(Path(filepath).rglob("parameters.npz"))
    rows = process_filenames(filenames, Path(filepath))

    out = []
    cache_key, evaluator = None, None
    for filename, dataset, partition, subject, epoch, xray in rows:
        try:
            true_pose, intrinsics = read_true(dataset, subject, xray, data_root, device)
        except FileNotFoundError:
            print(f"! no ground truth for {dataset}/{subject}/{xray}, skipping")
            continue
        key = (dataset, subject)
        if key != cache_key:
            evaluator = initialize_evaluator(dataset, subject, intrinsics, data_root,
                                             device=device)
            cache_key = key
        init_pose, ncc_i, final_pose, ncc_f, runtime = read_pred(filename, device)
        m_init = evaluator(true_pose, init_pose).cpu().numpy().reshape(-1)
        rec = dict(
            dataset=dataset, partition=partition, subject=subject, epoch=epoch,
            xray=xray, mpe_init=m_init[0], mrpe_init=m_init[1],
            mtre_init=m_init[2], dgeo_init=m_init[3], ncc_init=ncc_i,
        )
        if final_pose is not None:
            m_fin = evaluator(true_pose, final_pose).cpu().numpy().reshape(-1)
            rec.update(
                mpe=m_fin[0], mrpe=m_fin[1], mtre=m_fin[2], dgeo=m_fin[3],
                ncc=ncc_f, runtime=runtime,
            )
        out.append(rec)
        print(f"{dataset}/{subject}/{xray}: mTRE {rec.get('mtre', rec['mtre_init']):.2f} mm")

    if not out:
        print("No results evaluated.")
        return 0
    cols = sorted({k for r in out for k in r})
    with open(savepath, "w") as f:
        f.write(",".join(cols) + "\n")
        for r in out:
            f.write(",".join(str(r.get(c, "")) for c in cols) + "\n")
    print(f"Wrote {len(out)} rows to {savepath}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
