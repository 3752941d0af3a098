"""``train``: train a pose regression model.

Counterpart of ``xvr_tpu.cli.commands.train`` on ``argparse``: the same
options, short flags, defaults, ``nargs``, choices and help categories, in
the JAX package's category order. ``--device {cuda,cpu}`` (default
``cuda``) picks the device. ``--n_devices`` (default: every CUDA device with
``--device cuda``, else 1) above 1 trains on a device mesh of that many
cards, ``--mesh_rays`` of them along the ray axis.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ...config.trainer import args
from .register import existing_path

CATEGORY_ORDER = ["Required", "Data", "Sampling", "Renderer", "Model", "Optimizer", "Checkpoint",
                  "Logging", "TPU", "Miscellaneous"]


def _opt(help, category, **kw):
    return dict(help=help, category=category, **kw)


def _flag(help, category):
    return dict(action="store_true", default=False, help=help, category=category)


def _interval(help):
    return _opt(help, "Sampling", required=True, nargs=2, type=float)


N_DEVICES = (["--n_devices"], _opt(
    "Devices to train on (default: every CUDA device with --device cuda, else one; above 1 "
    "trains on a device mesh)", "TPU", default=None, type=int))
MESH_RAYS = (["--mesh_rays"], _opt(
    "Ray-parallel mesh axis size (default: auto; 1 = pure data parallel)", "TPU",
    default=None, type=int))
DEVICE = (["--device"], _opt("Device to train on; cpu runs the kernels' plain PyTorch versions",
                             "TPU", default="cuda", choices=["cuda", "cpu"]))

# (flags, argparse keywords with the help category), in the JAX package's order
OPTIONS = [
    (["-v", "--volpath"], _opt("CT volume to train on: one NIfTI file, or a directory of them "
                               "for multi-subject pretraining", "Required",
                               required=True, type=existing_path)),
    (["-m", "--maskpath"], _opt("Segmentation labelmap(s) matching volpath, enabling "
                                "structure-masked rendering", "Data", type=existing_path)),
    (["-c", "--ckptpath"], _opt("Existing model weights to start from (finetuning)", "Checkpoint",
                                type=existing_path)),
    (["-o", "--outpath"], _opt("Where checkpoints get written", "Required", required=True, type=str)),
    (["--r1"], _interval("Sampling interval for the primary rotation, degrees")),
    (["--r2"], _interval("Sampling interval for the secondary rotation, degrees")),
    (["--r3"], _interval("Sampling interval for the tertiary rotation, degrees")),
    (["--tx"], _interval("Sampling interval for translation along x, mm")),
    (["--ty"], _interval("Sampling interval for translation along y (source distance), mm")),
    (["--tz"], _interval("Sampling interval for translation along z, mm")),
    (["--sdd"], _opt("Focal length of the C-arm: X-ray source to detector plane, mm", "Renderer",
                     required=True, type=float)),
    (["--height"], _opt("Synthesized image side length, pixels", "Renderer", required=True, type=int)),
    (["--delx"], _opt("Detector pixel pitch, mm", "Renderer", required=True, type=float)),
    (["--renderer"], _opt(
        "Ray-integration model for DRR synthesis; on the card trilinear/siddon run the shear-warp "
        "kernels (siddon on an eps=0.25-voxel smoothed profile); *_exact pins the golden renderer "
        "(autodiff gradients, no kernel upgrade)", "Renderer", default=args.renderer,
        choices=["siddon", "trilinear", "siddon_exact", "trilinear_exact"])),
    (["--orientation"], _opt("Anatomical viewing convention for the volumes", "Renderer",
                             default=args.orientation, choices=["AP", "PA"])),
    (["--reverse_x_axis"], _flag("Mirror the detector x-axis (radiologic display convention)",
                                 "Renderer")),
    (["--model_name"], _opt("Backbone architecture for the pose regressor (resnet18/34/50/101)",
                            "Model", default=args.model_name, type=str)),
    (["--norm_layer"], _opt("Normalization used inside the backbone (groupnorm recommended)",
                            "Model", default=args.norm_layer, type=str)),
    (["--pretrained"], _flag("Initialize the backbone from ImageNet-1k weights (torchvision "
                             "state_dict via $XVR_PRETRAINED_DIR or the torch hub cache)", "Model")),
    (["--parameterization"], _opt("Rotation representation the network predicts", "Model",
                                  default=args.parameterization, type=str)),
    (["--convention"], _opt("Euler axis order when predicting euler_angles", "Model",
                            default=args.convention, type=str)),
    (["--unit_conversion_factor"], _opt("Multiplier mapping network translation outputs to mm",
                                        "Model", default=args.unit_conversion_factor, type=float)),
    (["--p_augmentation"], _opt("Chance each augmentation op fires on a training image", "Model",
                                default=args.p_augmentation, type=float)),
    (["--lr"], _opt("Peak learning rate of the warmup-cosine schedule", "Optimizer",
                    default=args.lr, type=float)),
    (["--weight_ncc"], _opt("Contribution of multiscale NCC image similarity to the loss",
                            "Optimizer", default=args.weight_ncc, type=float)),
    (["--weight_geo"], _opt("Contribution of the SE(3) double-geodesic pose error to the loss",
                            "Optimizer", default=args.weight_geo, type=float)),
    (["--weight_dice"], _opt("Contribution of mask-overlap Dice to the loss", "Optimizer",
                             default=args.weight_dice, type=float)),
    (["--weight_mvc"], _opt("Contribution of cross-view pose consistency to the loss", "Optimizer",
                            default=args.weight_mvc, type=float)),
    (["--batch_size"], _opt("Poses rendered and regressed per training step", "Sampling",
                            default=args.batch_size, type=int)),
    (["--n_total_itrs"], _opt("Total training steps", "Optimizer", default=args.n_total_itrs,
                              type=int)),
    (["--n_warmup_itrs"], _opt("Steps of linear LR ramp before cosine decay", "Optimizer",
                               default=args.n_warmup_itrs, type=int)),
    (["--n_grad_accum_itrs"], _opt("Steps whose gradients are averaged into one optimizer update",
                                   "Optimizer", default=args.n_grad_accum_itrs, type=int)),
    (["--n_save_every_itrs"], _opt("Checkpoint cadence, in steps", "Optimizer",
                                   default=args.n_save_every_itrs, type=int)),
    (["--disable_scheduler"], _flag("Hold the learning rate constant instead of warmup-cosine",
                                    "Optimizer")),
    (["--reuse_optimizer"], _flag("Also restore optimizer state from ckptpath (exact resume)",
                                  "Checkpoint")),
    (["-w", "--warp"], _opt("Rigid ITK/ANTs transform aligning this CT to the frame the "
                            "checkpoint was trained in", "Checkpoint", type=existing_path)),
    (["--invert"], _flag("Apply the warp transform inverted", "Checkpoint")),
    (["--patch_size"], _opt("Train on random sub-volumes of this size ('h,w,d') instead of whole "
                            "CTs", "Data", default=None, type=str)),
    (["--num_workers"], _opt("No-op here (kept so reference scripts parse); volumes stay resident "
                             "on device", "Data", default=args.num_workers, type=int)),
    (["--pin_memory"], _flag("No-op here (kept so reference scripts parse)", "Data")),
    (["--sample_weights"], _opt("File of per-volume sampling probabilities for multi-subject "
                                "training", "Data", default=None, type=existing_path)),
    (["--name"], _opt("Label for this run in the experiment log", "Logging", default=None, type=str)),
    (["--id"], _opt("Stable run identifier, letting a restart append to the same log", "Logging",
                    default=None, type=str)),
    (["--project"], _opt("Experiment-log project to file this run under", "Logging",
                         default=args.project, type=str)),
    N_DEVICES,
    MESH_RAYS,
    DEVICE,
]


def add_options(parser: argparse.ArgumentParser, options, order) -> None:
    groups = {c: parser.add_argument_group(f"{c} options") for c in order}
    for flags, kw in options:
        kw = dict(kw)
        groups[kw.pop("category")].add_argument(*flags, **kw)


def device_mesh(device: str, n: int | None, rays: int | None = None):
    """The device mesh of ``n`` CUDA devices that ``--n_devices`` asks for,
    or None for one device. The CPU is one device."""
    if n is None or n <= 1:
        return None
    if device != "cuda":
        raise ValueError(f"--n_devices {n}: a device mesh needs {n} CUDA devices, and "
                         f"--device {device} is one device")
    from ...parallel import make_mesh

    return make_mesh(n, rays=rays)


def mesh_request(kw, verb: str):
    """The trainer's mesh: ``--n_devices`` devices (default: every CUDA
    device with ``--device cuda``) along ``--mesh_rays``, built only above
    one device; ``verb`` names the run in the line that reports it."""
    n = kw["n_devices"]
    if n is None:
        import torch

        n = torch.cuda.device_count() if kw["device"] == "cuda" else 1
    mesh = device_mesh(kw["device"], n, kw["mesh_rays"])
    if mesh is not None:
        print(f"{verb} on {n} devices, mesh {mesh.shape}", flush=True)
    return mesh


def train(kw):
    """Train a pose regression model."""
    from ...train import Trainer
    from ..logging import start_run

    Path(kw["outpath"]).mkdir(parents=True, exist_ok=True)
    patch_size = kw["patch_size"]
    if patch_size is not None:
        patch_size = tuple(int(x) for x in patch_size.split(","))
    weights = (
        [float(line) for line in Path(kw["sample_weights"]).read_text().splitlines()]
        if kw["sample_weights"] is not None else None
    )
    (alphamin, alphamax), (betamin, betamax), (gammamin, gammamax) = kw["r1"], kw["r2"], kw["r3"]
    (txmin, txmax), (tymin, tymax), (tzmin, tzmax) = kw["tx"], kw["ty"], kw["tz"]
    config = dict(
        volpath=kw["volpath"], maskpath=kw["maskpath"], ckptpath=kw["ckptpath"],
        outpath=kw["outpath"],
        alphamin=alphamin, alphamax=alphamax, betamin=betamin, betamax=betamax,
        gammamin=gammamin, gammamax=gammamax, txmin=txmin, txmax=txmax,
        tymin=tymin, tymax=tymax, tzmin=tzmin, tzmax=tzmax,
        sdd=kw["sdd"], height=kw["height"], delx=kw["delx"], renderer=kw["renderer"],
        orientation=kw["orientation"], reverse_x_axis=kw["reverse_x_axis"],
        parameterization=kw["parameterization"], convention=kw["convention"],
        model_name=kw["model_name"], pretrained=kw["pretrained"], norm_layer=kw["norm_layer"],
        unit_conversion_factor=kw["unit_conversion_factor"],
        p_augmentation=kw["p_augmentation"], lr=kw["lr"], weight_ncc=kw["weight_ncc"],
        weight_geo=kw["weight_geo"], weight_dice=kw["weight_dice"], weight_mvc=kw["weight_mvc"],
        batch_size=kw["batch_size"], n_total_itrs=kw["n_total_itrs"],
        n_warmup_itrs=kw["n_warmup_itrs"], n_grad_accum_itrs=kw["n_grad_accum_itrs"],
        n_save_every_itrs=kw["n_save_every_itrs"], disable_scheduler=kw["disable_scheduler"],
        reuse_optimizer=kw["reuse_optimizer"], patch_size=patch_size,
        num_workers=kw["num_workers"], pin_memory=kw["pin_memory"], weights=weights,
        warp=kw["warp"], invert=kw["invert"],
    )
    run = start_run(project=kw["project"], name=kw["name"] or kw["project"], config=config,
                    id=kw["id"])
    trainer = Trainer(**config, mesh=mesh_request(kw, "Training"), device=kw["device"])
    trainer.train(run)
    return trainer


def add_train_parser(subparsers) -> argparse.ArgumentParser:
    p = subparsers.add_parser("train", help=train.__doc__, description=train.__doc__,
                              formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_options(p, OPTIONS, CATEGORY_ORDER)
    p.set_defaults(func=train)
    return p
