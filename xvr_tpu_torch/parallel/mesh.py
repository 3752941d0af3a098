"""The device mesh: data parallelism over poses, ray parallelism in a render.

Counterpart of ``xvr_tpu.parallel.mesh``. As in the JAX package, one Python
process drives every device: a :class:`Mesh` is a (dp, rays) grid of device
slots, and to shard a tensor is to split it into per-slot chunks in slot
order, each chunk on its slot's device, whose work then runs there (the
kernels launch on the slot's device). Results are gathered onto the first
slot's device with ``.to`` and ``torch.cat``; autograd carries the
cotangents back through the gathers and sums the gradients of the shards,
which is what the JAX package's psums do. Several slots may name one device
(``make_mesh(devices=...)``), as the JAX tests' virtual host devices do:
the work is then split the same way on one card.

* **dp**: the pose batch splits over the slots, each slot rendering whole
  images of its share (:func:`shard_batch`, :func:`shard_batch_flat`).
* **rays**: the detector's rays split over the slots
  (:func:`shard_rays`); :func:`ray_sharded_fast_render` splits one
  shear-warp render by detector rows, every row block warping from the
  slope grid fitted to the full detector.

The JAX package's ``replicate_tree`` pins the gradients' sharding for its
partitioner; here the gradients meet on the first slot's device by autograd,
so it has no counterpart.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from ..geometry import RigidTransform


class Mesh:
    """A (dp, rays) grid of device slots. ``devices`` is the (dp, rays)
    object array of ``torch.device``; ``shape`` maps the axis names to their
    sizes and ``size`` counts the slots, as a JAX mesh does."""

    axis_names = ("dp", "rays")

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def slots(self) -> list:
        """The devices of the slots in slot order (row-major over (dp, rays))."""
        return list(self.devices.flat)

    @property
    def first(self) -> torch.device:
        """The first slot's device, where shards are gathered."""
        return self.devices.flat[0]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: int | None = None, rays: int | None = None, devices=None) -> Mesh:
    """A (dp, rays) mesh over the first ``n_devices`` of ``devices`` (default:
    every CUDA device, ``cuda:0`` up). ``rays`` defaults to 2 when the count
    allows (even, at least 4), exercising both axes; ``rays=1`` is pure data
    parallelism. ``devices`` may name one device several times."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        kind = "CUDA devices"
    else:
        devices = [_device(d) for d in devices]
        kind = "devices given"
    n = len(devices) if n_devices is None else int(n_devices)
    if n > len(devices):
        raise ValueError(f"make_mesh: {n} slots asked for, but only {len(devices)} {kind}")
    if n < 1:
        raise ValueError(f"make_mesh: {n} slots asked for ({len(devices)} {kind}); a mesh "
                         "needs one at least")
    if rays is None:
        rays = 2 if n % 2 == 0 and n >= 4 else 1
    if n % rays:
        raise ValueError(f"n_devices={n} not divisible by rays={rays}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(n // rays, rays))


def on_device(device):
    """Make ``device`` current for the block (a CUDA device), so that the
    kernels launch on it; a no-op for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _split(x: torch.Tensor, n: int, dim: int, devices) -> list:
    return [c.to(d) for c, d in zip(torch.tensor_split(x, n, dim=dim), devices)]


def shard_batch(mesh: Mesh, x: torch.Tensor) -> list:
    """Split the leading (batch) axis over dp -> dp chunks, chunk i on the
    first slot of dp row i."""
    return _split(x, mesh.shape["dp"], 0, mesh.devices[:, 0])


def shard_batch_flat(mesh: Mesh, x: torch.Tensor) -> list:
    """Split the leading axis over every slot (the axes flattened): per-image
    work with no split inside an image, such as the CNN -> one chunk per
    slot, in slot order."""
    return _split(x, mesh.size, 0, mesh.slots)


def shard_rays(mesh: Mesh, x: torch.Tensor) -> list:
    """Split a (B, R, ...) ray tensor over (dp, rays): the batch over dp, the
    rays over rays -> one chunk per slot, in slot order."""
    rays = mesh.shape["rays"]
    return [c for row, blk in zip(mesh.devices, torch.tensor_split(x, mesh.shape["dp"], dim=0))
            for c in _split(blk, rays, 1, row)]


def replicated(mesh: Mesh, x) -> list:
    """``x`` (a tensor or a shear-warp operand, a tuple or list of them, or
    None) on every slot's device -> one per slot, copied once per distinct
    device."""
    from ..render.shearwarp import ShearWarpOperand

    copies = {}

    def to(v, d):
        if isinstance(v, (torch.Tensor, ShearWarpOperand)):
            return v.to(d)
        if isinstance(v, (tuple, list)):
            return type(v)(to(e, d) for e in v)
        return v

    return [copies.setdefault(d, to(x, d)) for d in mesh.slots]


def gather(mesh: Mesh, chunks, dim: int = 0) -> torch.Tensor:
    """Shards -> one tensor on the first slot's device (differentiable)."""
    return torch.cat([c.to(mesh.first) for c in chunks], dim=dim)


def _projectors(mesh: Mesh, projector) -> list:
    """The projector on each slot's device, moved once per distinct device."""
    moved = {}
    return [moved.setdefault(d, projector.to(d)) for d in mesh.slots]


def batch_sharded_render(mesh: Mesh, projector, pose: RigidTransform, density=None,
                         prepared=None) -> torch.Tensor:
    """Render a pose batch split over every slot, each slot rendering its
    poses whole with its copy of the volume (and of ``prepared``, the
    projector's :meth:`~xvr_tpu_torch.render.Projector.prepare`) -> raw
    (B, [C,] R) integrals on the first slot's device, as
    ``projector.render_rays`` gives them. Exact for every renderer: images
    are independent."""
    args = zip(_projectors(mesh, projector), shard_batch_flat(mesh, pose.matrix),
               replicated(mesh, density), replicated(mesh, prepared))
    outs = []
    for proj, mat, dens, prep in args:
        with on_device(proj.device):
            src, tgt = proj.rays(RigidTransform(mat))
            outs.append(proj.render_rays(src, tgt, density=dens, prepared=prep))
    return gather(mesh, outs)


def ray_sharded_render(mesh: Mesh, projector, pose: RigidTransform, density=None,
                       prepared=None) -> torch.Tensor:
    """Render a pose batch with its rays split over (dp, rays), the batch
    over dp -> raw (B, [C,] R) on the first slot's device. Exact for the
    renderers that integrate every ray on its own (the golden renderers and
    the slab kernels), not for shear-warp, whose slope grid is fitted to the
    rays it is given (:func:`ray_sharded_fast_render`)."""
    src, tgt = projector.rays(pose)
    rays = mesh.shape["rays"]
    srcs = [s for s in shard_batch(mesh, src) for _ in range(rays)]
    args = zip(_projectors(mesh, projector), srcs, shard_rays(mesh, tgt),
               replicated(mesh, density), replicated(mesh, prepared))
    outs = []
    for proj, s, t, dens, prep in args:
        with on_device(proj.device):
            outs.append(proj.render_rays(s.to(proj.device), t, density=dens, prepared=prep))
    rows = [gather(mesh, outs[i : i + rays], dim=-1) for i in range(0, len(outs), rays)]
    return torch.cat(rows, dim=0)


def ray_sharded_fast_render(mesh: Mesh, projector, pose: RigidTransform, density=None,
                            prepared=None) -> torch.Tensor:
    """Split ONE shear-warp render's detector rows across the mesh.

    The slope grid and march sign are fitted to the FULL detector first
    (:func:`~xvr_tpu_torch.render.shearwarp.shearwarp_grid_bounds`); every
    row block then accumulates (K1, repeated per block) and warps (K2) from
    the identical slope image, so the blocks together equal the unsharded
    fast render. Differentiable: each block's backward (K3, K4) runs under
    the same bounds and autograd sums the blocks' pose gradients. Returns
    raw (B, R) line integrals like ``projector.render_rays``.

    When B divides dp the pose batch splits over dp and the rows over rays;
    otherwise the batch is replicated and the rows split over every slot,
    so that a single render (B=1) spans the whole mesh. Rows that do not
    divide the row blocks are padded with copies of the last row (their
    integrals are dropped). ``prepared``: the projector's
    :meth:`~xvr_tpu_torch.render.Projector.prepare` operand, made here when
    None."""
    from ..render import shearwarp as sw

    if not projector.renderer.endswith(("_fast", "_shearwarp")):
        raise ValueError(f"fast renderer required, got {projector.renderer!r}")
    det = projector.detector
    H, W = det.height, det.width
    B = int(pose.matrix.shape[0])
    density = projector.density if density is None else density
    prepared = projector.prepare(density) if prepared is None else prepared
    if prepared.vol.ndim == 4:
        raise ValueError("ray sharding supports single-channel renders only")
    dp = mesh.shape["dp"]
    slots = mesh.devices if B % dp == 0 else mesh.devices.reshape(1, -1)
    n_b, n_row = slots.shape
    src, tgt = projector.rays(pose)
    grid_shape = projector.shearwarp_grid or sw.default_grid_shape((H, W))
    perm = projector.pallas_perm
    bounds = sw.shearwarp_grid_bounds(projector.affine_inverse, src, tgt, perm=perm,
                                      grid_shape=grid_shape)
    Hp = pad_to_multiple(H, n_row)
    if Hp != H:
        # copies of the last row: inside the full detector's grid bounds, and
        # their integrals are dropped below
        tgt = torch.cat([tgt, tgt[:, -W:, :].repeat(1, Hp - H, 1)], dim=1)
    eps = 0.25 if projector.renderer.startswith("siddon") else 1.0
    # (density, prepared, affine inverse) per slot, in slot order either way
    copies = replicated(mesh, (density, prepared, projector.affine_inverse))
    rows, nb = [], B // n_b
    for i, row_slots in enumerate(slots):
        b = slice(i * nb, (i + 1) * nb)
        blocks = []
        for j, (d, t_blk) in enumerate(zip(row_slots, torch.tensor_split(tgt[b], n_row, dim=1))):
            vol, prep, A = copies[i * n_row + j]
            with on_device(d):
                blocks.append(sw.raymarch_trilinear_fast(
                    vol, A, src[b].to(d), t_blk.to(d), det_shape=(Hp // n_row, W), perm=perm,
                    prepared=prep, grid_shape=grid_shape, eps=eps,
                    grid_bounds=tuple(x[b].to(d) for x in bounds),
                ))
        rows.append(gather(mesh, blocks, dim=1))
    raw = torch.cat(rows, dim=0)
    return raw[:, : H * W] if Hp != H else raw


def pad_to_multiple(n: int, m: int) -> int:
    return int(math.ceil(n / m) * m)
