"""Training defaults: counterpart of ``xvr_tpu.config.trainer``, with the
same values (a compatibility contract with the reference CLI: checkpoints
and scripts behave the same in either package)."""

from dataclasses import dataclass


@dataclass
class TrainerArgs:
    """Every ``train`` option that has a default."""

    # the pose-regression CNN: a GroupNorm ResNet with rotation and
    # translation heads (metres, scaled to mm by unit_conversion_factor)
    model_name: str = "resnet18"
    norm_layer: str = "groupnorm"
    pretrained: bool = False
    parameterization: str = "quaternion_adjugate"
    convention: str = "ZXY"
    unit_conversion_factor: float = 1000.0

    # DRR synthesis: trilinear/siddon upgrade to the shear-warp kernels on
    # the card; *_exact pins the golden renderers
    renderer: str = "trilinear"
    orientation: str = "AP"
    reverse_x_axis: bool = False

    # optimization: AGC-clipped Adam with warmup-cosine decay
    lr: float = 2e-4
    batch_size: int = 116
    n_total_itrs: int = 1_000_000
    n_warmup_itrs: int = 1_000
    n_grad_accum_itrs: int = 4
    n_save_every_itrs: int = 1_000
    disable_scheduler: bool = False
    weight_ncc: float = 1e0
    weight_geo: float = 1e-2
    weight_dice: float = 1e0
    weight_mvc: float = 0
    p_augmentation: float = 0.333

    # restarts
    reuse_optimizer: bool = False
    invert: bool = False

    # host-side loading: accepted for CLI parity; volumes stay on the device
    num_workers: int = 4
    pin_memory: bool = False

    # experiment tracking
    project: str = "xvr"


args = TrainerArgs()
