from .load import initialize_drr
from .projector import Projector, orientation_transform
from .shearwarp import (
    raymarch_siddon_fast,
    raymarch_siddon_shearwarp,
    raymarch_trilinear_fast,
    raymarch_trilinear_shearwarp,
)
from .volume import Volume, load_example_ct, make_test_volume, transform_hu_to_density
from .xla import raymarch_siddon, raymarch_trilinear

__all__ = [
    "Projector",
    "Volume",
    "initialize_drr",
    "load_example_ct",
    "make_test_volume",
    "orientation_transform",
    "raymarch_siddon",
    "raymarch_siddon_fast",
    "raymarch_siddon_shearwarp",
    "raymarch_trilinear",
    "raymarch_trilinear_fast",
    "raymarch_trilinear_shearwarp",
    "transform_hu_to_density",
]
