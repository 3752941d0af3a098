"""Command-line surface: ``python -m xvr_tpu_torch.cli``."""

from .cli import build_parser, main

__all__ = ["build_parser", "main"]
