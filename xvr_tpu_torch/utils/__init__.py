from .itk import ants_rigid_register, get_4x4, read_itk_transform
from .transforms import (
    center_crop,
    equalize,
    make_xray_transforms,
    normalize,
    resize,
    standardize,
)

__all__ = [
    "ants_rigid_register",
    "center_crop",
    "equalize",
    "get_4x4",
    "make_xray_transforms",
    "normalize",
    "read_itk_transform",
    "resize",
    "standardize",
]
