from .animate import animate, load_bundle, rebuild_projector, render_trajectory
from .viz2d import plot_drr, plot_mask, plot_registration

__all__ = [
    "animate",
    "load_bundle",
    "plot_drr",
    "plot_mask",
    "plot_registration",
    "rebuild_projector",
    "render_trajectory",
]
