"""Registration defaults: counterpart of ``xvr_tpu.config.registrar``, with
the same values (the compatibility contract of the reference CLI), grouped
by the stages of a run: read the X-ray, render DRRs, refine the pose,
write the results."""

from dataclasses import dataclass


@dataclass
class RegistrarArgs:
    """Every ``register`` option that has a default."""

    # X-ray ingestion
    crop: int = 0  # border pixels removed before everything else
    subtract_background: bool = False  # mode-value background removal
    linearize: bool = False  # log-transform to line integrals
    equalize: bool = False  # differentiable histogram equalization
    reducefn: str = "max"  # collapse rule for multi-frame DICOMs
    pattern: str = "*.dcm"  # glob for X-ray files under a directory

    # DRR synthesis during refinement; "trilinear" | "siddon" upgrade to the
    # kernels on the card, "*_exact" pins the golden renderer
    reverse_x_axis: bool = False
    renderer: str = "trilinear"
    voxel_shift: float = 0.0

    # Iterative refinement: a pyramid of detector downscale factors
    # (`scales`) with iterations per stage (`n_itrs`), Adam with split
    # rotation/translation rates and plateau-based early exit
    scales: str = "8"
    n_itrs: str = "500"
    parameterization: str = "euler_angles"
    convention: str = "ZXY"
    lr_rot: float = 1e-2
    lr_xyz: float = 1e0
    patience: int = 10  # iterations without improvement before an lr drop
    threshold: float = 1e-4  # relative improvement that resets the counter
    max_n_plateaus: int = 3  # lr drops before the stage exits
    # objective-gated re-anneals of the pyramid after the first pass
    max_restarts: int = 1
    # starts per pyramid pass: the current pose and S-1 jittered seeds
    restart_seeds: int = 4
    # starts swept through the coarsest stage only (when > restart_seeds)
    coarse_seeds: int = 0
    coarse_jitter_rot: float = 3.0  # deg, coarse-sweep jitter per seed
    coarse_jitter_xyz: float = 10.0  # mm, coarse-sweep jitter per seed
    restart_jitter_rot: float = 1.0  # deg, uniform jitter per seed
    restart_jitter_xyz: float = 4.0  # mm, uniform jitter per seed

    # Outputs and chatter
    init_only: bool = False  # stop after the initial pose (no refinement)
    saveimg: bool = False  # also write rendered PNG overlays
    verbose: int = 1


args = RegistrarArgs()
