from .transforms import (
    center_crop,
    equalize,
    make_xray_transforms,
    normalize,
    resize,
    standardize,
)

__all__ = [
    "center_crop",
    "equalize",
    "make_xray_transforms",
    "normalize",
    "resize",
    "standardize",
]
