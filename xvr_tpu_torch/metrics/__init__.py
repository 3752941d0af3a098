from .geodesic import double_geodesic, so3_angle
from .ncc import gaussian_blur, gradient_ncc, local_ncc, make_imagesim, multiscale_ncc, ncc, sobel

__all__ = [
    "double_geodesic",
    "gaussian_blur",
    "gradient_ncc",
    "local_ncc",
    "make_imagesim",
    "multiscale_ncc",
    "ncc",
    "so3_angle",
    "sobel",
]
