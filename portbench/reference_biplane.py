"""The plain reference of the biplane cell, in PyTorch, on any device.

It imports nothing of the program. From the unmasked volume and the X-ray
pixels that the benchmark wrote, it works out again what the registrar
reports at a pose: the whole volume's attenuation (no labelmap, no crop),
the X-ray's own march permutation, its render at the pyramid's finest stage
and the similarity, through the frozen functions of
:mod:`portbench.reference` (the volume read in bfloat16, everything after it
in float32 with TF32 off, or, for the control, the render's hat factors,
their products and the slope image rounded to bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference as ref


def density(hu: torch.Tensor) -> torch.Tensor:
    """The unmasked volume's attenuation: air (the background of a
    subtracted angiogram) maps to zero."""
    return ref.hu_to_density(hu)


def fine_detector(det: ref.Detector, scales) -> ref.Detector:
    """The pyramid's finest stage of the uncropped detector."""
    return ref.stage_detectors(det, scales, 0)[-1]


class Renderer:
    """The volume's bf16 copies in each march permutation asked for, made
    once each."""

    def __init__(self, hu: torch.Tensor, affine: np.ndarray, device):
        self.density = density(hu.to(device))
        self.affine = np.asarray(affine, np.float64)
        self.affine_inverse = torch.as_tensor(np.linalg.inv(self.affine), dtype=torch.float32,
                                              device=device)
        self.packed = {}

    def permutation(self, pose: torch.Tensor) -> tuple:
        """The X-ray's own (march, window, lane) axes at ``pose`` (1, 4, 4)."""
        return ref.permutation(pose, np.linalg.inv(self.affine))

    def pack(self, perm: tuple) -> torch.Tensor:
        """The bf16 volume in ``perm``'s axis order."""
        if perm not in self.packed:
            self.packed[perm] = self.density.permute(*perm).contiguous().to(torch.bfloat16)
        return self.packed[perm]

    def __call__(self, pose: torch.Tensor, det: ref.Detector, precision: str = "float32"):
        """Line integrals (1, H, W) at ``pose`` (1, 4, 4) on ``det``."""
        perm = self.permutation(pose)
        return ref.render(self.pack(perm), self.affine_inverse, pose, det, perm, precision)


def similarity(render: Renderer, pose, pixels: np.ndarray, det: ref.Detector, linearize: bool,
               precision: str = "float32") -> float:
    """The similarity at ``pose`` (4, 4) of the render on ``det`` (the fine
    stage) against the stored X-ray ``pixels`` as the registrar preprocesses
    them (no crop)."""
    dev = render.affine_inverse.device
    pose = torch.as_tensor(np.asarray(pose), dtype=torch.float32, device=dev).reshape(1, 4, 4)
    img = render(pose, det, precision)[:, None]
    xray = ref.preprocess_xray(pixels, 0, linearize).to(dev)
    s = ref.similarity(ref.xray_transform(xray, det.height, det.width),
                       ref.xray_transform(img, det.height, det.width))
    return float(s[0])
