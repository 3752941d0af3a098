"""Initial pose predicted by a trained pose-regression CNN.

Counterpart of ``xvr_tpu.registrar.model``: one forward pass of the
checkpointed :class:`~xvr_tpu_torch.models.PoseRegressor` on the
intrinsics-resampled X-ray gives the starting pose, optionally re-framed
through an ITK/ANTs warp into patient coordinates and/or mirrored to its
antipode to resolve the PA/AP flip. The checkpoint may come from either
package.
"""

from __future__ import annotations

from ..io.xray import read_xray
from ..models.inference import construct_antipode, correct_pose, predict_pose
from ..models.regressor import load_model
from .base import RegistrarBase, clinical_defaults


class RegistrarModel(RegistrarBase):
    def __init__(
        self, volume, mask, ckptpath,
        warp=None, invert=False, antipodal=False, **kwargs,
    ):
        self.ckptpath = ckptpath
        self.model, self.params, self.config, self.date = load_model(
            ckptpath, meta=True, device=kwargs.get("device", "cuda")
        )
        self.warp = warp
        self.invert = invert
        self.antipodal = antipodal

        super().__init__(
            volume, mask, self.config["orientation"],
            save_kwargs={
                "type": "model",
                "ckptpath": str(ckptpath),
                "date": self.date,
                "warp": str(warp) if warp is not None else None,
                "invert": invert,
            },
            **clinical_defaults(kwargs),
        )

    def initialize_pose(self, i2d, return_resampled: bool = False):
        gt, sdd, delx, dely, x0, y0, pf_to_af = read_xray(
            i2d, self.crop, self.subtract_background, self.linearize, self.reducefn
        )
        init_pose, resampled_gt = predict_pose(
            self.model, self.params, self.config, gt, sdd, delx, dely, x0, y0
        )
        init_pose = correct_pose(init_pose, self.warp, self.volume, self.invert)
        if self.antipodal:
            init_pose = construct_antipode(init_pose)
        if return_resampled:
            return gt, sdd, delx, dely, x0, y0, pf_to_af, init_pose, resampled_gt
        return gt, sdd, delx, dely, x0, y0, pf_to_af, init_pose
