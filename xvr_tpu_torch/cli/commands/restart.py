"""``restart``: resume training from a checkpoint.

Counterpart of ``xvr_tpu.cli.commands.restart`` on ``argparse``: the
checkpoint's config is rehydrated with ``reuse_optimizer=True``, so the run
resumes at the checkpoint's iteration with its optimizer state. Checkpoints
of either package resume in the port.
"""

from __future__ import annotations

import argparse

from .register import existing_path
from .train import DEVICE, MESH_RAYS, N_DEVICES, add_options, mesh_request

CATEGORY_ORDER = ["TPU", "Miscellaneous"]

OPTIONS = [
    (["-c", "--ckptpath"], dict(required=True, type=existing_path, category="Miscellaneous",
                                help="Checkpoint (or directory of them) to resume training from")),
    (["--id"], dict(default=None, type=str, category="Miscellaneous",
                    help="Stable run identifier, letting the restart append to the same log")),
    (["--project"], dict(default=None, type=str, category="Miscellaneous",
                         help="Experiment-log project to file this run under")),
    N_DEVICES,
    MESH_RAYS,
    DEVICE,
]


def restart(kw):
    """Resume training exactly where a checkpoint left off."""
    from ...train import Trainer
    from ...train.checkpoint import latest_checkpoint, load_checkpoint
    from ..logging import start_run

    ckptpath = str(latest_checkpoint(kw["ckptpath"]))
    config = dict(load_checkpoint(ckptpath)["config"])
    config["ckptpath"] = ckptpath
    config["reuse_optimizer"] = True
    config.pop("seed", None)
    project = kw["project"] or "xvr"
    run = start_run(project=project, name=project, config=config, id=kw["id"])
    trainer = Trainer(**config, mesh=mesh_request(kw, "Resuming"), device=kw["device"])
    trainer.train(run)
    return trainer


def add_restart_parser(subparsers) -> argparse.ArgumentParser:
    p = subparsers.add_parser("restart", help=restart.__doc__, description=restart.__doc__,
                              formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_options(p, OPTIONS, CATEGORY_ORDER)
    p.set_defaults(func=restart)
    return p
