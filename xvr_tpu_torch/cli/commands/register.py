"""``register {model,dicom,fixed,restart}``: iterative 2D/3D registration.

Counterpart of ``xvr_tpu.cli.commands.register`` on ``argparse``: the same
options, short flags, defaults, ``nargs``, choices and help categories (as
argument groups, in the JAX package's category order), and the same epilog.
X-ray arguments may be files or directories globbed by ``--pattern``. One
addition: ``--device {cuda,cpu}`` (default ``cuda``) is the caller's request
for a device; ``--n_devices`` above 1 registers on a data-parallel mesh of
that many CUDA devices.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ...config.registrar import args

CATEGORY_ORDER = ["Required", "Model", "Renderer", "Preprocessing", "Optimizer", "Logging",
                  "Miscellaneous"]


def existing_path(value: str) -> str:
    if not Path(value).exists():
        raise argparse.ArgumentTypeError(f"Path '{value}' does not exist.")
    return value


class IntRange:
    """An int in [lo, hi] (click's ``IntRange``)."""

    def __init__(self, lo: int, hi: int):
        self.lo, self.hi = lo, hi

    def __call__(self, value: str) -> int:
        n = int(value)
        if not self.lo <= n <= self.hi:
            raise argparse.ArgumentTypeError(f"{n} is not in the range {self.lo}<=x<={self.hi}.")
        return n


def _flag(help, category):
    return dict(action="store_true", default=False, help=help, category=category)


# (flags, argparse keywords with the help category); in the JAX package's order
BASE_OPTIONS = [
    (["-v", "--volume"], dict(required=True, type=existing_path,
                              help="Preoperative CT to register the X-ray against", category="Required")),
    (["-m", "--mask"], dict(type=existing_path,
                            help="Segmentation labelmap paired with the CT", category="Renderer")),
    (["-o", "--outpath"], dict(required=True, type=str,
                               help="Where result bundles get written", category="Required")),
    (["--crop"], dict(default=args.crop, type=int,
                      help="Pixels trimmed from every X-ray border before processing", category="Preprocessing")),
    (["--subtract_background"], _flag(
        "Remove the most frequent intensity (background level) from the X-ray", "Preprocessing")),
    (["--linearize"], _flag("Log-transform the X-ray into line-integral space", "Preprocessing")),
    (["--equalize"], _flag("Run differentiable histogram equalization on both X-ray and DRRs",
                           "Preprocessing")),
    (["--reducefn"], dict(default=args.reducefn, type=str,
                          help="How to collapse a multi-frame DICOM to one image (max/sum/index)",
                          category="Preprocessing")),
    (["--labels"], dict(type=str, help="Restrict rendering to these labelmap values (comma-separated)",
                        category="Renderer")),
    (["--scales"], dict(default=args.scales, type=str,
                        help="Detector downscale factor per pyramid stage, coarse to fine (comma-separated)",
                        category="Optimizer")),
    (["--n_itrs"], dict(default=args.n_itrs, type=str,
                        help="Optimization budget per pyramid stage (comma-separated)",
                        category="Optimizer")),
    (["--reverse_x_axis"], _flag("Mirror the detector x-axis (radiologic display convention)",
                                 "Renderer")),
    (["--renderer"], dict(default=args.renderer,
                          choices=["siddon", "trilinear", "siddon_exact", "trilinear_exact"],
                          help="Ray-integration model for DRR synthesis; on the card trilinear/siddon "
                               "run the shear-warp kernels (the slab kernels under "
                               "XVR_NO_SHEARWARP=1); *_exact pins the golden renderer (autodiff "
                               "gradients, no kernel upgrade)",
                          category="Renderer")),
    (["--parameterization"], dict(default=args.parameterization, type=str,
                                  help="Rotation representation optimized over", category="Optimizer")),
    (["--convention"], dict(default=args.convention, type=str,
                            help="Euler axis order when optimizing euler_angles", category="Optimizer")),
    (["--voxel_shift"], dict(default=args.voxel_shift, type=float,
                             help="Half-voxel origin offset (corner- vs center-anchored grids)",
                             category="Renderer")),
    (["--lr_rot"], dict(default=args.lr_rot, type=float,
                        help="Starting Adam step size for rotation", category="Optimizer")),
    (["--lr_xyz"], dict(default=args.lr_xyz, type=float,
                        help="Starting Adam step size for translation", category="Optimizer")),
    (["--patience"], dict(default=args.patience, type=int,
                          help="Stale iterations tolerated before the step size is cut 10x",
                          category="Optimizer")),
    (["--threshold"], dict(default=args.threshold, type=float,
                           help="Relative similarity gain that counts as progress", category="Optimizer")),
    (["--max_n_plateaus"], dict(default=args.max_n_plateaus, type=int,
                                help="Step-size cuts allowed before a stage exits early",
                                category="Optimizer")),
    (["--max_restarts"], dict(default=args.max_restarts, type=int,
                              help="Objective-gated pyramid re-anneals after the first pass (0 = single pass)",
                              category="Optimizer")),
    (["--restart_seeds"], dict(default=args.restart_seeds, type=int,
                               help="Starts per pyramid pass: the current pose + S-1 jittered seeds, "
                                    "batched; argmax-similarity wins (1 = single-start)",
                               category="Optimizer")),
    (["--restart_jitter_rot"], dict(default=args.restart_jitter_rot, type=float,
                                    help="Rotational jitter of re-anneal seeds (degrees)",
                                    category="Optimizer")),
    (["--restart_jitter_xyz"], dict(default=args.restart_jitter_xyz, type=float,
                                    help="Translational jitter of re-anneal seeds (mm)",
                                    category="Optimizer")),
    (["--coarse_seeds"], dict(default=args.coarse_seeds, type=int,
                              help="Starts swept through the coarsest stage only; best continue "
                                   "(enabled when > restart_seeds, else a warned no-op; 0 = off)",
                              category="Optimizer")),
    (["--coarse_jitter_rot"], dict(default=args.coarse_jitter_rot, type=float,
                                   help="Rotational jitter of coarse-sweep seeds (degrees)",
                                   category="Optimizer")),
    (["--coarse_jitter_xyz"], dict(default=args.coarse_jitter_xyz, type=float,
                                   help="Translational jitter of coarse-sweep seeds (mm)",
                                   category="Optimizer")),
    (["--init_only"], _flag("Skip refinement entirely; report the initialization", "Logging")),
    (["--saveimg"], _flag("Also write PNG renders of the X-ray and final DRR", "Logging")),
    (["--pattern"], dict(default=args.pattern, type=str,
                         help="Filename glob used when an XRAY argument is a directory",
                         category="Preprocessing")),
    (["--verbose"], dict(default=args.verbose, type=IntRange(0, 3),
                         help="Console chatter, 0 (silent) to 3 (per-iteration)", category="Logging")),
    (["--max_batch"], dict(default=8, type=IntRange(1, 128),
                           help="X-rays registered per batched optimization (1 = one at a time)",
                           category="Optimizer")),
    (["--n_devices"], dict(default=None, type=int,
                           help="Shard a batched registration over this many CUDA devices "
                                "(default: single)",
                           category="Optimizer")),
    (["--device"], dict(default="cuda", choices=["cuda", "cpu"],
                        help="Device to register on; cpu runs the kernels' plain PyTorch versions",
                        category="Optimizer")),
]

# the CLI passes every option above explicitly, so its defaults are the
# reference's; direct API construction applies clinical_defaults instead
EPILOG = (
    "Defaults shown are the reference CLI contract (n_itrs 500, no "
    "linearize, no reverse_x_axis). Constructing a Registrar directly "
    "from Python applies clinical presets instead when these kwargs are "
    "omitted (linearize=True, reverse_x_axis=True, n_itrs='100'); see "
    "docs/migration.md."
)

_ORIENTATION = (["--orientation"], dict(default="AP", choices=["AP", "PA"],
                                        help="Anatomical viewing convention of the CT",
                                        category="Required"))


def _base_kwargs(kw):
    from .train import device_mesh

    return dict(
        # pure data parallelism over the X-ray batch (rays=1: a registration's
        # renders split by rows only when its batch does not fill the mesh)
        mesh=device_mesh(kw["device"], kw.get("n_devices"), rays=1),
        labels=kw["labels"], crop=kw["crop"],
        subtract_background=kw["subtract_background"], linearize=kw["linearize"],
        equalize=kw["equalize"], reducefn=kw["reducefn"], scales=kw["scales"],
        n_itrs=kw["n_itrs"], reverse_x_axis=kw["reverse_x_axis"],
        renderer=kw["renderer"], parameterization=kw["parameterization"],
        convention=kw["convention"], voxel_shift=kw["voxel_shift"],
        lr_rot=kw["lr_rot"], lr_xyz=kw["lr_xyz"], patience=kw["patience"],
        threshold=kw["threshold"], max_n_plateaus=kw["max_n_plateaus"],
        max_restarts=kw["max_restarts"], restart_seeds=kw["restart_seeds"],
        restart_jitter_rot=kw["restart_jitter_rot"],
        restart_jitter_xyz=kw["restart_jitter_xyz"],
        coarse_seeds=kw["coarse_seeds"],
        coarse_jitter_rot=kw["coarse_jitter_rot"],
        coarse_jitter_xyz=kw["coarse_jitter_xyz"],
        init_only=kw["init_only"], saveimg=kw["saveimg"], verbose=kw["verbose"],
        device=kw["device"],
    )


def model(kw):
    """Initialize from a pose regression model."""
    from ...registrar import RegistrarModel

    registrar = RegistrarModel(
        kw["volume"], kw["mask"], kw["ckptpath"],
        warp=kw["warp"], invert=kw["invert"], antipodal=kw["antipodal"],
        **_base_kwargs(kw),
    )
    run(registrar, kw["xray"], kw["pattern"], kw["verbose"], kw["outpath"], kw["max_batch"])


def dicom(kw):
    """Initialize from the DICOM parameters of the X-ray."""
    from ...registrar import RegistrarDicom

    registrar = RegistrarDicom(kw["volume"], kw["mask"], kw["orientation"], **_base_kwargs(kw))
    run(registrar, kw["xray"], kw["pattern"], kw["verbose"], kw["outpath"], kw["max_batch"])


def fixed(kw):
    """Initialize from a fixed pose."""
    from ...registrar import RegistrarFixed

    registrar = RegistrarFixed(
        kw["volume"], kw["mask"], kw["orientation"],
        list(kw["rot"]), list(kw["xyz"]), **_base_kwargs(kw)
    )
    run(registrar, kw["xray"], kw["pattern"], kw["verbose"], kw["outpath"], kw["max_batch"])


def restart(kw):
    """Initialize from a previous final pose estimate."""
    import numpy as np
    import torch

    from ...geometry import RigidTransform
    from ...registrar import RegistrarRestart

    data = np.load(kw["ckpt"])
    pose = RigidTransform(torch.as_tensor(data["final_pose"], device=kw["device"]))
    registrar = RegistrarRestart(
        kw["volume"], kw["mask"], kw["orientation"], pose, **_base_kwargs(kw)
    )
    run(registrar, kw["xray"], kw["pattern"], kw["verbose"], kw["outpath"], kw["max_batch"])


# subcommand -> (function, its own options before the shared ones)
COMMANDS = {
    "model": (model, [
        (["-c", "--ckptpath"], dict(required=True, type=existing_path,
                                    help="Trained pose-regressor weights providing the initial pose",
                                    category="Required")),
        (["--warp"], dict(type=existing_path, category="Miscellaneous",
                          help="Rigid ITK/ANTs transform into the model's training frame")),
        (["--invert"], _flag("Apply the warp transform inverted", "Miscellaneous")),
        (["--antipodal"], _flag("Also try the 180-degree-flipped prediction (PA/AP ambiguity)",
                                "Miscellaneous")),
    ]),
    "dicom": (dicom, [_ORIENTATION]),
    "fixed": (fixed, [
        _ORIENTATION,
        (["--rot"], dict(required=True, nargs=3, type=float,
                         help="Starting rotation (three components)", category="Required")),
        (["--xyz"], dict(required=True, nargs=3, type=float,
                         help="Starting translation (three components, mm)", category="Required")),
    ]),
    "restart": (restart, [
        _ORIENTATION,
        (["--ckpt"], dict(required=True, type=existing_path,
                          help="Result bundle of an earlier run; its final pose seeds this one",
                          category="Required")),
    ]),
}


def add_register_parser(subparsers) -> argparse.ArgumentParser:
    """Add ``register`` and its four subcommands to ``subparsers``."""
    doc = "Initialize and refine the pose of an X-ray with iterative optimization."
    register = subparsers.add_parser("register", help=doc, description=doc)
    sub = register.add_subparsers(dest="subcommand", required=True, metavar="{model,dicom,fixed,restart}")
    for name, (fn, own) in COMMANDS.items():
        p = sub.add_parser(name, help=fn.__doc__, description=fn.__doc__, epilog=EPILOG,
                           formatter_class=argparse.ArgumentDefaultsHelpFormatter)
        p.add_argument("xray", nargs="+", type=existing_path, help="X-ray DICOM files or directories")
        groups = {c: p.add_argument_group(f"{c} options") for c in CATEGORY_ORDER}
        for flags, kw in own + BASE_OPTIONS:
            kw = dict(kw)
            groups[kw.pop("category")].add_argument(*flags, **kw)
        p.set_defaults(func=fn)
    return register


def run(registrar, xray, pattern, verbose, outpath, max_batch=8):
    dcmfiles = parse_dcmfiles(xray, pattern)
    if len(dcmfiles) > 1 and max_batch > 1:
        # joint optimization over intrinsics-matched groups: one batched
        # render per iteration covers up to max_batch X-rays
        if verbose > 0:
            print(f"\nRegistering {len(dcmfiles)} X-rays (batched) ....", flush=True)
        registrar.register_files(dcmfiles, outpath, max_batch=max_batch)
        return
    for i2d in dcmfiles:
        if verbose > 0:
            print(f"\nRegistering {i2d} ....", flush=True)
        registrar(i2d, outpath)


def parse_dcmfiles(xray, pattern):
    dcmfiles = []
    for xpath in xray:
        xpath = Path(xpath)
        if xpath.is_file():
            dcmfiles.append(xpath)
        else:
            dcmfiles += sorted(xpath.glob(pattern))
    return dcmfiles
