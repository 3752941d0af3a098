"""``animate``: turn a saved registration run back into a video.

Counterpart of ``xvr_tpu.cli.commands.animate`` on ``argparse``: the result
bundle that ``register`` writes is replayed, a DRR re-rendered at every
recorded pose (on ``--device``) and the frames stitched into an animation.
"""

from __future__ import annotations

import argparse

from .register import existing_path
from .train import DEVICE, add_options

OPTIONS = [
    (["-i", "--inpath"], dict(required=True, type=existing_path, category="Miscellaneous",
                              help="Result bundle written by <register> (directory or "
                                   "parameters file)")),
    (["-o", "--outpath"], dict(required=True, type=str, category="Miscellaneous",
                               help="Where to write the rendered animation")),
    (["--skip"], dict(default=1, type=int, category="Miscellaneous",
                      help="Stride through the trajectory, rendering every Nth iterate")),
    (["--dpi"], dict(default=192, type=int, category="Miscellaneous",
                     help="Resolution of each rendered frame")),
    (["--fps"], dict(default=30, type=int, category="Miscellaneous",
                     help="Playback rate of the resulting video")),
    (["--device"], dict(DEVICE[1], category="Miscellaneous",
                        help="Device to re-render on, with the bundle's renderer")),
]


def animate(kw):
    """Replay a registration trajectory as a rendered animation."""
    from ...visualization.animate import animate as render_animation

    return render_animation(kw["inpath"], kw["outpath"], skip=kw["skip"], dpi=kw["dpi"],
                            fps=kw["fps"], device=kw["device"])


def add_animate_parser(subparsers) -> argparse.ArgumentParser:
    p = subparsers.add_parser("animate", help=animate.__doc__, description=animate.__doc__,
                              formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_options(p, OPTIONS, ["Miscellaneous"])
    p.set_defaults(func=animate)
    return p
