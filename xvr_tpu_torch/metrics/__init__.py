from .dice import dice_coefficient, dice_loss
from .evaluator import Evaluator
from .geodesic import double_geodesic, so3_angle
from .ncc import gaussian_blur, gradient_ncc, local_ncc, make_imagesim, multiscale_ncc, ncc, sobel

__all__ = [
    "Evaluator",
    "dice_coefficient",
    "dice_loss",
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
