"""Carry state into the port from plain arrays and values.

The registration state is the CT, the labelmap, the affine, the detector
intrinsics, the projector's renderer fields and the pose matrices.
:func:`from_numpy_state` builds the port's
:class:`~xvr_tpu_torch.render.Volume`, :class:`~xvr_tpu_torch.render.Projector`
and :class:`~xvr_tpu_torch.geometry.RigidTransform` from NumPy arrays and
plain Python values, so any producer of those (a saved bundle, or the fields
of another implementation's projector) can hand its state over.

The pose regressor's weights travel in flax's parameter tree, the layout of
the JAX package's checkpoints: :func:`from_flax_params` turns such a tree
into a :class:`~xvr_tpu_torch.models.PoseRegressor` state dict and
:func:`to_flax_params` turns the module back into the tree.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import Detector, RigidTransform
from .render.projector import Projector
from .render.volume import Volume, transform_hu_to_density


def from_numpy_state(
    data,
    affine,
    *,
    detector: dict,
    mask=None,
    orientation: str | None = "AP",
    density=None,
    renderer: str = "trilinear",
    labels=None,
    n_samples: int = 256,
    voxel_shift: float = 0.0,
    pallas_perm=None,
    pallas_window: int = 32,
    pallas_remap: bool = False,
    shearwarp_window: int = 48,
    shearwarp_grid=None,
    shearwarp_remap: bool = False,
    pose=None,
    device="cuda",
) -> tuple[Projector, Volume, RigidTransform | None]:
    """-> (projector, volume, pose or None), all on ``device``.

    ``data`` (nx, ny, nz) intensities, ``affine`` (4, 4) voxel -> world mm,
    ``mask`` an optional integer labelmap (rendered as channels when
    ``labels`` names some of its values), ``density`` the attenuation grid
    (computed from ``data`` by the HU transfer when omitted), ``detector`` a
    dict of :class:`~xvr_tpu_torch.geometry.Detector` fields and ``pose``
    optional (B, 4, 4) or (4, 4) matrices."""

    def t(x, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(x)), dtype=dtype, device=device)

    volume = Volume(
        data=t(data),
        affine=t(affine, torch.float32),
        mask=None if mask is None else t(mask, torch.int32),
        orientation=orientation,
    )
    dens = transform_hu_to_density(volume.data) if density is None else t(density, torch.float32)
    det = Detector(**{k: v for k, v in detector.items()})
    projector = Projector(
        volume=volume,
        density=dens,
        detector=det,
        renderer=str(renderer),
        labels=None if labels is None else tuple(int(x) for x in labels),
        n_samples=int(n_samples),
        voxel_shift=float(voxel_shift),
        pallas_perm=None if pallas_perm is None else tuple(int(p) for p in pallas_perm),
        pallas_window=int(pallas_window),
        pallas_remap=bool(pallas_remap),
        shearwarp_window=int(shearwarp_window),
        shearwarp_grid=None if shearwarp_grid is None else tuple(int(x) for x in shearwarp_grid),
        shearwarp_remap=bool(shearwarp_remap),
    )
    rt = None if pose is None else RigidTransform(t(pose, torch.float32))
    return projector, volume, rt


# flax's tree <-> the PoseRegressor's state dict. Conv kernels are HWIO in
# flax and OIHW in torch; dense kernels are (in, out) against torch's
# (out, in). A norm k of a scope is ``_AdaptiveGroupNorm_k/GroupNorm_0`` or
# ``LayerNorm_k`` in flax, ``norms.k`` in torch; the heads are ``Dense_0``
# (rotation) and ``Dense_1`` (translation).
_HEADS = ("rot_head", "xyz_head")
_BLOCKS = ("BasicBlock_", "BottleneckBlock_")


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _norm_node(scope: dict, k: int) -> dict:
    if f"LayerNorm_{k}" in scope:
        return scope[f"LayerNorm_{k}"]
    return scope[f"_AdaptiveGroupNorm_{k}"]["GroupNorm_0"]


def from_flax_params(tree: dict) -> dict[str, torch.Tensor]:
    """A flax ``PoseRegressor`` parameter tree (``{"params": ...}`` or its
    inside; NumPy arrays, bf16 leaves as tensors) -> a float32 state dict
    for :class:`~xvr_tpu_torch.models.PoseRegressor`."""
    p = tree.get("params", tree)
    sd: dict[str, torch.Tensor] = {}

    def conv(scope, k, name):
        sd[f"{name}.weight"] = _f32(scope[f"Conv_{k}"]["kernel"]).permute(3, 2, 0, 1).contiguous()

    def norm(scope, k, name):
        node = _norm_node(scope, k)
        sd[f"{name}.weight"], sd[f"{name}.bias"] = _f32(node["scale"]), _f32(node["bias"])

    net = p["ResNet_0"]
    conv(net, 0, "backbone.conv1")
    norm(net, 0, "backbone.norm1")
    blocks = sorted((k for k in net if k.startswith(_BLOCKS)), key=lambda k: int(k.rsplit("_", 1)[1]))
    for b, key in enumerate(blocks):
        scope = net[key]
        for k in range(sum(name.startswith("Conv_") for name in scope)):
            conv(scope, k, f"backbone.blocks.{b}.convs.{k}")
            norm(scope, k, f"backbone.blocks.{b}.norms.{k}")
    for i, head in enumerate(_HEADS):
        dense = p[f"Dense_{i}"]
        sd[f"{head}.weight"] = _f32(dense["kernel"]).T.contiguous()
        sd[f"{head}.bias"] = _f32(dense["bias"])
    return sd


def to_flax_params(module, tensors: dict | None = None) -> dict:
    """A :class:`~xvr_tpu_torch.models.PoseRegressor` -> its flax parameter
    tree, ``{"params": ...}`` with float32 NumPy leaves. ``tensors``, a dict
    keyed by the module's state-dict names (an optimizer's moments), is laid
    out in place of the module's own weights."""
    tensors = module.state_dict() if tensors is None else tensors
    sd = {k: v.detach().to("cpu", torch.float32).numpy() for k, v in tensors.items()}
    layernorm = module.backbone.norm_layer == "layernorm"

    def add(scope, k, conv, norm):
        """flax's ``Conv_k`` and norm ``k`` from torch's ``conv`` and ``norm``."""
        scope[f"Conv_{k}"] = {"kernel": np.ascontiguousarray(sd[f"{conv}.weight"].transpose(2, 3, 1, 0))}
        node = {"scale": sd[f"{norm}.weight"], "bias": sd[f"{norm}.bias"]}
        if layernorm:
            scope[f"LayerNorm_{k}"] = node
        else:
            scope[f"_AdaptiveGroupNorm_{k}"] = {"GroupNorm_0": node}

    net: dict = {}
    add(net, 0, "backbone.conv1", "backbone.norm1")
    for b, blk in enumerate(module.backbone.blocks):
        scope: dict = {}
        for k in range(len(blk.convs)):
            add(scope, k, f"backbone.blocks.{b}.convs.{k}", f"backbone.blocks.{b}.norms.{k}")
        net[f"{type(blk).__name__}_{b}"] = scope
    params = {"ResNet_0": net}
    for i, head in enumerate(_HEADS):
        params[f"Dense_{i}"] = {"kernel": np.ascontiguousarray(sd[f"{head}.weight"].T),
                                "bias": sd[f"{head}.bias"]}
    return {"params": params}
