"""The port's command line: ``python -m xvr_tpu_torch.cli``.

Counterpart of ``xvr_tpu.cli.cli`` on ``argparse`` (the port runs without
``click``): ``-v/--version``, ``train``, ``restart``, the ``register
{model,dicom,fixed,restart}`` group, ``animate`` and ``dcm2nii``. A
``--device cuda`` request on a machine with no CUDA device fails.
"""

from __future__ import annotations

import argparse

from .. import __version__
from .commands.animate import add_animate_parser
from .commands.dcm2nii import add_dcm2nii_parser
from .commands.register import add_register_parser
from .commands.restart import add_restart_parser
from .commands.train import add_train_parser


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m xvr_tpu_torch.cli",
        description="xvr-tpu, PyTorch/CUDA port: 2D/3D X-ray to volume registration.",
    )
    parser.add_argument("-v", "--version", action="version",
                        version=f"%(prog)s, version {__version__}")
    sub = parser.add_subparsers(dest="command", required=True,
                                metavar="{train,restart,register,animate,dcm2nii}")
    add_train_parser(sub)
    add_restart_parser(sub)
    add_register_parser(sub)
    add_animate_parser(sub)
    add_dcm2nii_parser(sub)
    return parser


def main(argv=None) -> int:
    """Parse ``argv`` (default: ``sys.argv[1:]``) and run the command."""
    kw = vars(build_parser().parse_args(argv))
    if kw.get("device") == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu)")
    kw.pop("func")(kw)
    return 0
