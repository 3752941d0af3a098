from . import so3
from .detector import Detector
from .se3 import (
    N_ANGULAR_COMPONENTS,
    RigidTransform,
    convert,
    make_matrix,
    make_translation,
    project_onto_SO3,
    se3_exp_map,
    se3_log_map,
)

__all__ = [
    "Detector",
    "N_ANGULAR_COMPONENTS",
    "RigidTransform",
    "convert",
    "make_matrix",
    "make_translation",
    "project_onto_SO3",
    "se3_exp_map",
    "se3_log_map",
    "so3",
]
