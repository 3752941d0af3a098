"""The Projector: volume + detector -> differentiable DRR rendering.

Counterpart of ``xvr_tpu.render.projector``: a frozen dataclass holding the
volume, its precomputed attenuation grid (on the volume's device), the
detector and the renderer choice. Functional updates (``replace``,
``set_intrinsics``, ``rescale_detector``, ``with_shearwarp``,
``with_pallas``) return new projectors that share the tensors.

Renderers: ``trilinear`` and ``siddon`` (the golden renderers),
``trilinear_fast``/``siddon_fast`` (shear-warp forward + analytic adjoint),
``trilinear_shearwarp``/``siddon_shearwarp`` (forward only),
``trilinear_pallas`` (the slab kernels K5/K6, and K7 with a labelmap) and
``siddon_pallas`` (the exact Siddon slab kernel K8, forward only).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace as _replace

import numpy as np
import torch

from ..geometry.detector import Detector
from ..geometry.se3 import RigidTransform
from ..utils.profiling import host_sync
from . import xla
from .layout import choose_permutation_for_pose, measured_steepness
from .volume import Volume, transform_hu_to_density

_SHEARWARP = ("trilinear_shearwarp", "trilinear_fast", "siddon_shearwarp", "siddon_fast")
_SLAB = ("trilinear_pallas", "siddon_pallas")


def kernel_upgrade_allowed(device) -> bool:
    """Whether the registrar and the trainer may upgrade a golden renderer to
    the hand-written kernels: on a CUDA device, or on any under
    ``XVR_FORCE_SHEARWARP`` (the CPU tests set it), and never under
    ``XVR_NO_PALLAS``."""
    return ((torch.device(device).type == "cuda" or bool(os.environ.get("XVR_FORCE_SHEARWARP")))
            and not os.environ.get("XVR_NO_PALLAS"))


def _batched(pose: RigidTransform) -> RigidTransform:
    if pose.matrix.ndim == 2:
        return RigidTransform(pose.matrix[None])
    return pose


def orientation_transform(orientation: str | None, dtype=torch.float32, device="cuda") -> RigidTransform:
    """Camera-frame pre-rotation for anatomical orientation: identity for
    "AP" (and None), a 180 degree turn about x for "PA"."""
    if orientation == "PA":
        flip = torch.eye(4, dtype=dtype, device=device)
        flip.diagonal()[1:3] = -1.0  # made on the device: a render copies nothing from the host
        return RigidTransform(flip)
    if orientation in (None, "AP"):
        return RigidTransform(torch.eye(4, dtype=dtype, device=device))
    raise ValueError(f"Unrecognized orientation {orientation!r}")


@dataclass(frozen=True)
class Projector:
    volume: Volume
    density: torch.Tensor
    detector: Detector
    renderer: str = "trilinear"
    labels: tuple[int, ...] | None = None
    n_samples: int = 256
    voxel_shift: float = 0.0
    # volume-axis permutation (march, window, lane) of the kernels
    pallas_perm: tuple[int, int, int] | None = None
    # TPU slab-kernel gather window and ray remap, accepted for parity and
    # unused on the GPU
    pallas_window: int = 32
    pallas_remap: bool = False
    # TPU gather-window fields, accepted for parity and unused on the GPU
    shearwarp_window: int = 48
    shearwarp_grid: tuple[int, int] | None = None
    shearwarp_bounds: tuple[tuple[int, int], ...] | None = None
    shearwarp_remap: bool = False

    # -- construction --------------------------------------------------------
    @classmethod
    def from_volume(
        cls,
        volume: Volume,
        sdd: float,
        height: int,
        delx: float,
        width: int | None = None,
        dely: float | None = None,
        x0: float = 0.0,
        y0: float = 0.0,
        reverse_x_axis: bool = False,
        renderer: str = "trilinear",
        labels=None,
        n_samples: int | None = None,
        voxel_shift: float = 0.0,
        bone_attenuation_multiplier: float = 1.0,
    ) -> "Projector":
        det = Detector(
            sdd=float(sdd),
            height=int(height),
            width=int(width if width is not None else height),
            delx=float(delx),
            dely=float(dely if dely is not None else delx),
            x0=float(x0),
            y0=float(y0),
            reverse_x_axis=bool(reverse_x_axis),
        )
        if n_samples is None:
            # ~1 sample per voxel along the volume diagonal, a multiple of 8
            diag = float(np.linalg.norm(np.asarray(volume.shape, np.float32)))
            n_samples = int(-(-int(diag) // 8) * 8)
        if labels is not None:
            labels = tuple(int(x) for x in labels)
        density = transform_hu_to_density(volume.data, bone_attenuation_multiplier)
        return cls(
            volume=volume, density=density, detector=det, renderer=renderer, labels=labels,
            n_samples=int(n_samples), voxel_shift=float(voxel_shift),
        )

    @property
    def device(self) -> torch.device:
        return self.density.device

    @property
    def kernels(self) -> str | None:
        """The hand-written kernels that render: ``"shearwarp"`` (K1-K4, whose
        slope grid is fitted to the rays of a render), ``"slab"`` (K5-K8), or
        None for the golden renderers."""
        if self.renderer in _SHEARWARP:
            return "shearwarp"
        if self.renderer in _SLAB:
            return "slab"
        return None

    def replace(self, **kwargs) -> "Projector":
        return _replace(self, **kwargs)

    def to(self, device) -> "Projector":
        """The projector with its volume and density on ``device`` (itself
        when they are there already)."""
        device = torch.device(device)
        if self.density.device == device:
            return self
        v = self.volume
        vol = Volume(data=v.data.to(device), affine=v.affine.to(device),
                     mask=None if v.mask is None else v.mask.to(device),
                     orientation=v.orientation)
        return self.replace(volume=vol, density=self.density.to(device))

    def set_intrinsics(self, **kwargs) -> "Projector":
        det = self.detector.replace(**{k: v for k, v in kwargs.items() if v is not None})
        return self.replace(detector=det)

    def rescale_detector(self, scale: float) -> "Projector":
        return self.replace(detector=self.detector.rescale(scale))

    def oriented_rotations(self, pose: RigidTransform) -> np.ndarray:
        """The rotations of the oriented poses, (K, 3, 3) float64 on the host:
        one read of the device."""
        oriented = self._oriented(_batched(pose))
        host_sync(oriented.R)
        return oriented.R.detach().cpu().double().numpy().reshape(-1, 3, 3)

    def _mean_pose_R(self, reference_pose, rotations=None) -> np.ndarray:
        """Mean rotation of the oriented reference poses (the orientation's
        own rotation without one), on the host; of ``rotations`` instead,
        where given, the oriented rotations :meth:`oriented_rotations` read
        already, which are not read again."""
        if rotations is not None:
            return np.asarray(rotations).reshape(-1, 3, 3).mean(axis=0)
        if reference_pose is not None:
            return self.oriented_rotations(reference_pose).mean(axis=0)
        return orientation_transform(self.volume.orientation, device="cpu").R.numpy()

    def with_pallas(self, reference_pose=None, window: int | None = None,
                    probe_poses=None, rotations=None) -> "Projector":
        """Switch the trilinear renderer to the slab kernels
        (``trilinear_pallas``), fixing the volume-axis permutation from a
        representative pose. Returns ``self`` unchanged when probe rays
        (``probe_poses``, else the reference pose) exceed 45 degrees of the
        march axis (steepness > 1.2), where one sample per march plane
        undersamples, as the JAX package does. ``window`` is kept when
        given; the GPU kernels have no gather window to measure.
        ``rotations`` stands for the reference pose's oriented rotations."""
        Ainv = self.affine_inverse_host()
        perm = choose_permutation_for_pose(self._mean_pose_R(reference_pose, rotations), Ainv)
        proj = self.replace(
            renderer="trilinear_pallas",
            pallas_perm=perm,
            pallas_window=int(window) if window is not None else self.pallas_window,
        )
        probes = probe_poses if probe_poses is not None else reference_pose
        if probes is not None:
            src, tgt = proj.rays_host(probes)
            if measured_steepness(src, tgt, Ainv, perm) > 1.2:
                print(
                    "with_pallas: rays exceed 45deg of the march axis; "
                    "keeping the golden renderer",
                    flush=True,
                )
                return self
        return proj

    def tuned_for(self, poses, quantum: int = 8) -> "Projector":
        """The JAX package re-measures its slab gather window and ray layout
        here; the GPU kernels read any volume row, so the projector is
        returned as it is."""
        return self

    def measure_window(self, poses, quantum: int = 8) -> int:
        """The slab gather window for ``poses``: on the GPU no window clips,
        so this is the projector's own ``pallas_window``."""
        if self.pallas_perm is None:
            raise ValueError("measure_window requires pallas_perm (use with_pallas)")
        return int(self.pallas_window)

    def with_shearwarp(
        self,
        reference_pose=None,
        probe_poses=None,
        differentiable: bool = True,
        grid_shape: tuple[int, int] | None = None,
        quantum: int = 8,
        flavor: str | None = None,
        rotations=None,
    ) -> "Projector":
        """Switch to the shear-warp renderer (``{flavor}_fast`` when
        ``differentiable``, else the forward-only ``{flavor}_shearwarp``),
        fixing the volume-axis permutation from a representative pose.
        Returns ``self`` unchanged when probe rays exceed ~70 degrees of the
        march axis (steepness > 2.8), as the JAX package does. With a labelmap
        the label channels' slab ranges are fixed here (``shearwarp_bounds``).
        The GPU warp needs no gather window, so none is measured.
        ``rotations`` stands for the reference pose's oriented rotations."""
        if flavor is None:
            flavor = "siddon" if self.renderer.startswith("siddon") else "trilinear"
        if flavor not in ("trilinear", "siddon"):
            raise ValueError(f"unknown shear-warp flavor {flavor!r}")
        Ainv = self.affine_inverse_host()
        perm = choose_permutation_for_pose(self._mean_pose_R(reference_pose, rotations), Ainv)
        chan_bounds = None
        if self.labels is not None and self.volume.mask is not None:
            from .shearwarp import channel_slab_bounds

            # compact label channels march only their bounding slab range
            chan_bounds = channel_slab_bounds(self.volume.mask, self.labels, perm)
        proj = self.replace(
            renderer=f"{flavor}_fast" if differentiable else f"{flavor}_shearwarp",
            pallas_perm=perm,
            pallas_remap=False,
            shearwarp_grid=tuple(int(x) for x in grid_shape) if grid_shape else None,
            shearwarp_bounds=chan_bounds,
        )
        probes = probe_poses if probe_poses is not None else reference_pose
        if probes is not None:
            src, tgt = proj.rays_host(probes)
            if measured_steepness(src, tgt, Ainv, perm) > 2.8:
                print(
                    "with_shearwarp: rays exceed ~70deg of the march axis; "
                    "keeping the golden renderer",
                    flush=True,
                )
                return self
        return proj

    # -- geometry passthrough ------------------------------------------------
    @property
    def affine_inverse(self) -> torch.Tensor:
        Ainv = self.volume.affine_inverse
        if self.voxel_shift:
            Ainv = Ainv.clone()
            Ainv[:3, 3] += self.voxel_shift
        return Ainv

    def _oriented(self, pose: RigidTransform) -> RigidTransform:
        reorient = orientation_transform(
            self.volume.orientation, pose.matrix.dtype, pose.matrix.device
        )
        return RigidTransform(pose.matrix @ reorient.matrix)

    def rays(self, pose: RigidTransform, calibration=None):
        """(source, target) world-space ray endpoints."""
        return self.detector.rays(self._oriented(pose), calibration)

    def rays_host(self, pose: RigidTransform):
        """Host-side NumPy ray endpoints for steepness measurements."""
        host_sync(pose.matrix)
        M = _batched(pose).matrix.detach().cpu().double().numpy()
        F = orientation_transform(self.volume.orientation, torch.float64, "cpu").matrix.numpy()
        return self.detector.rays_numpy(M @ F)

    def affine_inverse_host(self) -> np.ndarray:
        host_sync(self.volume.affine)
        return self.affine_inverse.detach().cpu().numpy().astype(np.float32)

    def perspective_projection(self, pose: RigidTransform, pts: torch.Tensor) -> torch.Tensor:
        return self.detector.perspective_projection(self._oriented(pose), pts)

    def inverse_projection(self, pose: RigidTransform, pts: torch.Tensor) -> torch.Tensor:
        return self.detector.inverse_projection(self._oriented(pose), pts)

    # -- rendering -----------------------------------------------------------
    def prepare(self, density: torch.Tensor | None = None):
        """The volume operand the renderer reads, permuted and cast once (hoist
        out of optimization loops; pass as ``prepared``): shear-warp's
        :meth:`prepare_for_shearwarp` with its content boxes (a
        ``ShearWarpOperand``), the slab kernels' :meth:`pack_for_pallas`,
        None for the golden renderers, which read the density."""
        if self.kernels == "shearwarp":
            from .shearwarp import ShearWarpOperand, content_boxes

            vol = self.prepare_for_shearwarp(density)
            return ShearWarpOperand(vol, content_boxes(vol))
        if self.kernels == "slab":
            return self.pack_for_pallas(density)
        return None

    def pack_for_pallas(self, density: torch.Tensor | None = None):
        """Permute and cast the density for the slab kernels -> (table, its
        shape)."""
        from .pallas import pack_density

        density = self.density if density is None else density
        if self.pallas_perm is None:
            raise ValueError("pack_for_pallas requires pallas_perm (use with_pallas)")
        return pack_density(density, self.pallas_perm)

    def prepare_for_shearwarp(self, density: torch.Tensor | None = None) -> torch.Tensor:
        """Permute and cast the density for the shear-warp renderer. With a
        labelmap, the (C, M, Wd, L) channel stack."""
        from .shearwarp import prepare_shearwarp

        density = self.density if density is None else density
        if self.pallas_perm is None:
            raise ValueError("prepare_for_shearwarp requires pallas_perm (use with_shearwarp)")
        mask = self.volume.mask if self.labels is not None else None
        return prepare_shearwarp(density, self.pallas_perm, mask=mask, labels=self.labels)

    def render_rays(self, source, target, density=None, mask=None, prepared=None):
        """Integrate rays given world-space endpoints -> (B, R). ``prepared``
        is :meth:`prepare`'s operand, made per call when None."""
        density = self.density if density is None else density
        mask = self.volume.mask if mask is None else mask
        labels = self.labels if mask is not None else None
        if self.renderer in _SHEARWARP:
            from .shearwarp import raymarch_trilinear_fast, raymarch_trilinear_shearwarp

            eps = 0.25 if self.renderer.startswith("siddon") else 1.0
            kwargs = dict(
                det_shape=(self.detector.height, self.detector.width),
                perm=self.pallas_perm,
                prepared=prepared,
                grid_shape=self.shearwarp_grid,
                mask=mask, labels=labels, eps=eps,
                chan_bounds=self.shearwarp_bounds if labels is not None else None,
            )
            if self.renderer.endswith("_fast"):
                return raymarch_trilinear_fast(density, self.affine_inverse, source, target, **kwargs)
            return raymarch_trilinear_shearwarp(density, self.affine_inverse, source, target, **kwargs)
        if self.renderer in _SLAB:
            from .pallas import raymarch_siddon_pallas, raymarch_trilinear_pallas

            kwargs = dict(
                mask=mask, labels=labels,
                det_shape=(self.detector.height, self.detector.width),
                window=self.pallas_window, perm=self.pallas_perm, packed=prepared,
                remap=self.pallas_remap,
            )
            if self.renderer == "siddon_pallas":
                return raymarch_siddon_pallas(density, self.affine_inverse, source, target, **kwargs)
            return raymarch_trilinear_pallas(density, self.affine_inverse, source, target,
                                             n_samples=self.n_samples, **kwargs)
        if self.renderer == "trilinear":
            return xla.raymarch_trilinear(
                density, self.affine_inverse, source, target,
                n_samples=self.n_samples, mask=mask, labels=labels,
            )
        if self.renderer == "siddon":
            return xla.raymarch_siddon(
                density, self.affine_inverse, source, target, mask=mask, labels=labels,
            )
        raise ValueError(f"Unknown renderer {self.renderer!r}")

    def reshape_transform(self, img: torch.Tensor, batch_size: int) -> torch.Tensor:
        """Flat ray dim -> image (B, C, H, W)."""
        return img.reshape(batch_size, -1, self.detector.height, self.detector.width)

    def __call__(self, pose: RigidTransform, density=None, mask=None, calibration=None,
                 prepared=None) -> torch.Tensor:
        """Render DRRs at a batch of poses -> (B, C, H, W)."""
        squeeze = pose.matrix.ndim == 2
        if squeeze:
            pose = RigidTransform(pose.matrix[None])
        source, target = self.rays(pose, calibration)
        img = self.render_rays(source, target, density=density, mask=mask, prepared=prepared)
        img = self.reshape_transform(img, batch_size=pose.matrix.shape[0])
        return img[0] if squeeze else img
