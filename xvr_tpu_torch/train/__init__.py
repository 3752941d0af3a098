from .augmentations import apply_augmentations, draw_augmentations, xray_augmentations
from .checkpoint import latest_checkpoint, load_checkpoint, restore_into, save_checkpoint
from .loss import pose_regression_loss
from .optim import AGCAdamMultiSteps
from .sampler import get_random_pose
from .schedule import identity_schedule, warmup_cosine_schedule
from .trainer import Trainer, pad_volumes

__all__ = [
    "AGCAdamMultiSteps",
    "Trainer",
    "apply_augmentations",
    "draw_augmentations",
    "get_random_pose",
    "identity_schedule",
    "latest_checkpoint",
    "load_checkpoint",
    "pad_volumes",
    "pose_regression_loss",
    "restore_into",
    "save_checkpoint",
    "warmup_cosine_schedule",
    "xray_augmentations",
]
