"""The test-time optimization engine for 2D/3D registration.

Counterpart of ``xvr_tpu.registrar.base``. One pyramid stage is a Python loop
(the JAX package compiles it as one ``lax.while_loop``; on a CUDA device with
the shear-warp renderer and no mesh, each iteration is one replay of a CUDA
graph, and the host only checks the exit condition): per iteration, pose
-> ``convert`` -> rays -> render -> X-ray transforms -> beta * mNCC +
(1 - beta) * gNCC -> gradient -> Adam ascent, with a per-image plateau state
machine (ReduceLROnPlateau semantics), an lr warmup, argmax-pose tracking and
a rescoring of the last iterate. ``run_batch`` adds the optional wide
coarse-stage sweep, multi-start pass 1 and the objective-gated re-anneal.
Every image of a batch has its own optimizer state; an image whose plateau
budget is spent freezes while the rest go on.

Under a device ``mesh`` (:func:`xvr_tpu_torch.parallel.make_mesh`) a stage's
renders are split over the mesh's slots, as the JAX package shards them: the
stage's K images (X-rays times seeds) over every slot when K divides the
mesh, else each shear-warp render by detector rows
(:func:`~xvr_tpu_torch.parallel.ray_sharded_fast_render`); the golden
renderers' images split as the former, and the slab kernels' renders stay
whole. The similarity, Adam and the plateau state run on the first slot's
device, which is the registrar's device.
"""

from __future__ import annotations

import functools
import json
import os
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..geometry import RigidTransform, convert
from ..metrics.ncc import make_imagesim
from ..render.load import initialize_drr
from ..render import _cuda
from ..render.layout import choose_permutation_for_pose
from ..render.projector import Projector, kernel_upgrade_allowed
from ..utils.profiling import count, host_sync, span
from ..utils.transforms import make_xray_transforms

# Placeholder intrinsics used before a real DICOM is parsed
PLACEHOLDER = dict(height=1436, width=1436, sdd=1020.0, delx=0.194, dely=0.194)


def clinical_defaults(kwargs: dict) -> dict:
    """Defaults the concrete registrars flip relative to ``RegistrarBase``;
    explicitly passed values win."""
    kwargs = dict(kwargs)
    kwargs.setdefault("linearize", True)
    kwargs.setdefault("n_itrs", "100")
    kwargs.setdefault("reverse_x_axis", True)
    return kwargs


def _parse_scales(scales: list[str] | str, crop: int, height: int) -> list[float]:
    """Per-stage absolute coarsening factors from full resolution: stage
    ``x`` renders at ``(height + crop) / x`` pixels."""
    if isinstance(scales, str):
        scales = scales.split(",")
    return [float(x) * height / (height + crop) for x in scales]


def _drift_probes(pose: RigidTransform, rot_deg: float = 15.0, t_mm: float = 30.0) -> RigidTransform:
    """Probe poses around every pose of the batch: camera-frame rotation
    corners (+-rot_deg about every axis) at translation pushes of +-t_mm."""
    rots, xyzs = [], []
    for sa in (-1.0, 1.0):
        for sb in (-1.0, 1.0):
            for sg in (-1.0, 1.0):
                for st in (-1.0, 1.0):
                    rots.append([sa * rot_deg, sb * rot_deg, sg * rot_deg])
                    xyzs.append([st * t_mm] * 3)
    dev = pose.matrix.device
    off = convert(
        torch.tensor(rots, dtype=torch.float32, device=dev),
        torch.tensor(xyzs, dtype=torch.float32, device=dev),
        "euler_angles", "ZXY", degrees=True,
    )
    mat = pose.matrix.reshape(-1, 4, 4)
    return RigidTransform((mat[:, None] @ off.matrix[None]).reshape(-1, 4, 4))


def _host(x: torch.Tensor) -> np.ndarray:
    host_sync(x)
    return x.detach().cpu().numpy()


# Adam's constants (the reference's)
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
# rows of a stage's clock tables and records: the least power of two that
# holds n_itr, and at least this many, so that stages of one shape share a
# graph whatever their n_itr up to it
_GRAPH_ROWS = 1024
_MAX_STAGE_GRAPHS = 8  # cached per registrar
# their stages run op by op: rotation_10d's conversion reads the host (eigh
# checks its result there), which a CUDA graph cannot hold, and
# quaternion_adjugate's has not been tried under capture
_HOST_BOUND_PARAMETERIZATIONS = ("rotation_10d", "quaternion_adjugate")


def _graphs_engage(projector: Projector, mesh, parameterization: str) -> bool:
    """Whether a stage replays its iterations as a CUDA graph: on a CUDA
    device, without a mesh (whose renders gather across devices), with the
    shear-warp renderer (K1-K4; the slab kernels' and the golden renderers'
    stages stay op by op) and a parameterization that a graph can hold."""
    return (mesh is None and projector.renderer.endswith("_fast")
            and projector.device.type == "cuda"
            and parameterization not in _HOST_BOUND_PARAMETERIZATIONS)


def _march_groups(rotations: np.ndarray, affine_inverse: np.ndarray) -> list[list[int]]:
    """The X-rays' indices grouped by the march axis of the permutation that
    each one's own oriented rotation gives (``rotations`` (K, 3, 3)), the
    groups in the order of their first X-ray."""
    groups: dict[int, list[int]] = {}
    for k, R in enumerate(rotations):
        groups.setdefault(choose_permutation_for_pose(R, affine_inverse)[0], []).append(k)
    return list(groups.values())


def _rows(t: torch.Tensor, idx: list[int]) -> torch.Tensor:
    """The rows ``idx`` of ``t``: a view where they follow one another (every
    batch of one march axis), else a copy of their slices (no index copied to
    the device)."""
    if idx == list(range(idx[0], idx[-1] + 1)):
        return t[idx[0] : idx[-1] + 1]
    return torch.cat([t[k : k + 1] for k in idx])


@functools.lru_cache(maxsize=8)
def _clock_table(rows: int, warmup: float, dtype: torch.dtype) -> np.ndarray:
    """(6, rows), for iteration i: Adam's bias corrections 1 - b**(i + 1) as
    ``dtype`` scalars give them, their float32 reciprocals, the lr warmup
    min((i + 1) / warmup, 1) and whether patience ticks, i + 1 >= warmup."""
    b1, b2 = torch.tensor(_B1, dtype=dtype), torch.tensor(_B2, dtype=dtype)
    cols = []
    for i in range(rows):
        t = torch.tensor(i + 1.0, dtype=dtype)
        c1, c2 = float(1 - b1**t), float(1 - b2**t)
        cols.append((c1, c2, np.float32(1.0) / np.float32(c1), np.float32(1.0) / np.float32(c2),
                     min((i + 1.0) / warmup, 1.0), i + 1.0 >= warmup))
    return np.asarray(cols, dtype=np.float64).T


class _Clock:
    """The stage loop's per-iteration scalars from tables on the device, read
    at a counter on the device, so that a captured iteration reads the
    current iteration's values: Adam's bias corrections, the lr warmup,
    whether patience ticks, the iteration's number and its record row."""

    def __init__(self, rows: int, warmup: float, dtype, device):
        table = _clock_table(rows, warmup, dtype)
        host_sync(device, 2)
        self.c1, self.c2, self.inv_c1, self.inv_c2, self.warm_tab = torch.tensor(
            table[:5], dtype=dtype).to(device)
        self.tick_tab = torch.tensor(table[5] > 0).to(device)
        self.ctr = torch.zeros(1, dtype=torch.int64, device=device)

    def _at(self, table):
        return table.index_select(0, self.ctr)

    def unbias(self, m, v):
        """Adam's moments over their bias corrections, as a division by a
        Python float gives them: a CUDA tensor is multiplied by the float's
        float32 reciprocal, a CPU tensor divided by the float."""
        if m.device.type == "cuda":
            return m * self._at(self.inv_c1), v * self._at(self.inv_c2)
        return m / self._at(self.c1), v / self._at(self.c2)

    def warm(self):
        return self._at(self.warm_tab)

    def ticking(self):
        return self._at(self.tick_tab)

    def itr(self, like):
        return (self.ctr + 1).to(like.dtype)

    def record(self, buf, row) -> None:
        buf.index_copy_(0, self.ctr, row[None])

    def advance(self) -> None:
        self.ctr.add_(1)


@dataclass(frozen=True)
class _Settings:
    """What a stage's iterations read besides their buffers. Stages of equal
    settings share one cached stage and its graph: the projector counts by
    its volume's identity (the cached stage keeps that volume alive) and its
    other fields, the buffers by their shapes."""

    projector: Projector = field(compare=False)
    mesh: object = field(compare=False)
    transform: Callable = field(compare=False)
    imagesim: Callable = field(compare=False)
    volume: int
    view: Projector  # the projector without its tensors
    shapes: tuple  # the poses', the X-ray's
    rows: int
    lr_rot: float
    lr_xyz: float
    similarity: tuple  # (mncc_patch_size, gncc_patch_size, sigma, beta)
    equalize: bool
    parameterization: str
    convention: str | None
    patience: int
    threshold: float
    max_n_plateaus: int
    warmup: float
    graphed: bool


class _Stage:
    """One pyramid stage's loop over its buffers: the loop's state ``st``,
    its records ``rec`` (the pose after each step, the similarity before it,
    the lrs), the :class:`_Clock`, the X-ray ``gt`` and the ``prepared``
    volume, which :meth:`load` fills at each stage's start. Where the
    settings are ``graphed`` an iteration is one replay of a CUDA graph: the
    first after the buffers are made runs op by op on a side stream (cuBLAS,
    cuDNN and the autograd engine set themselves up there), the next is
    captured and replayed, and every later one, in any stage of equal
    settings, is one replay. Elsewhere an iteration runs op by op."""

    def __init__(self, cfg: _Settings, rot, xyz, gt, prepared):
        self.cfg = cfg
        K, dev, fdt = rot.shape[0], rot.device, rot.dtype
        self.st = self._fresh(rot, xyz, 0)
        self.rec = (torch.zeros((cfg.rows, K, 6), dtype=fdt, device=dev),
                    torch.zeros((cfg.rows, K), dtype=fdt, device=dev),
                    torch.zeros((cfg.rows, K, 2), dtype=fdt, device=dev))
        self.clock = _Clock(cfg.rows, cfg.warmup, fdt, dev)
        self.gt, self.prepared, self.density = gt, prepared, None
        self.stream = self.graph = self.launches = None
        self.warmed = False

    @staticmethod
    def _fresh(rot, xyz, n_itr: int) -> dict:
        """The loop's state at a stage's start."""
        K = rot.shape[0]
        dev, fdt = rot.device, rot.dtype
        rot, xyz = rot.detach().clone(), xyz.detach().clone()
        return dict(
            rot=rot, xyz=xyz, m_r=torch.zeros_like(rot), v_r=torch.zeros_like(rot),
            m_x=torch.zeros_like(xyz), v_x=torch.zeros_like(xyz),
            b_rot=rot.clone(), b_xyz=xyz.clone(),
            best_raw=torch.full((K,), -float("inf"), dtype=fdt, device=dev),
            lr_scale=torch.ones((K,), dtype=fdt, device=dev),
            best=torch.full((K,), -float("inf"), dtype=fdt, device=dev),
            num_bad=torch.zeros((K,), dtype=torch.int32, device=dev),
            # the reference's lr-drop counter starts at +inf, so the first
            # step counts one plateau
            n_plateaus=torch.zeros((K,), dtype=torch.int32, device=dev),
            current_lr=torch.full((K,), float("inf"), dtype=fdt, device=dev),
            done_itr=torch.full((K,), n_itr, dtype=torch.int32, device=dev),
        )

    def load(self, rot, xyz, gt, density, prepared, n_itr: int) -> None:
        """The stage's start into the buffers."""
        for k, v in self._fresh(rot, xyz, n_itr).items():
            self.st[k].copy_(v)
        for buf in self.rec:
            buf.zero_()
        self.clock.ctr.zero_()
        for buf, v in ((self.gt, gt), (self.prepared, prepared)):
            if buf is not v:
                buf.copy_(v)
        self.density = density

    def _rendered(self, rot, xyz):
        cfg, p, mesh = self.cfg, self.cfg.projector, self.cfg.mesh
        pose = convert(rot, xyz, parameterization=cfg.parameterization, convention=cfg.convention)
        B = pose.matrix.shape[0]
        if mesh is None or p.kernels == "slab" or (B % mesh.size and p.kernels != "shearwarp"):
            return p(pose, density=self.density, prepared=self.prepared)
        from ..parallel import mesh as pmesh

        if B % mesh.size == 0:
            # each slot renders its share of the images whole
            raw = pmesh.batch_sharded_render(mesh, p, pose, density=self.density,
                                             prepared=self.prepared)
        else:
            # a batch that does not divide the mesh: every render's rows
            # split over the slots, so a single registration uses them all
            raw = pmesh.ray_sharded_fast_render(mesh, p, pose, density=self.density,
                                                prepared=self.prepared)
        return p.reshape_transform(raw, B)

    def running(self, i: int, n_itr: int) -> bool:
        """The loop's exit check: the host waits for the device's answer."""
        if i >= n_itr:
            return False
        with span("register.exit_check"):
            n_plateaus = self.st["n_plateaus"]
            host_sync(n_plateaus)
            return bool((n_plateaus < self.cfg.max_n_plateaus).any())

    def iterate(self) -> dict:
        """One iteration from the state ``st`` -> the new state; the records
        are written in place at the clock's row."""
        cfg, st, clock = self.cfg, self.st, self.clock
        K = st["rot"].shape[0]
        with span("register.render"):
            r_ = st["rot"].detach().requires_grad_(True)
            x_ = st["xyz"].detach().requires_grad_(True)
            img = self._rendered(r_, x_)
        with span("register.similarity"):
            sims = cfg.imagesim(self.gt, cfg.transform(img))
        with span("register.backward"):
            g_r, g_x = torch.autograd.grad(sims.sum(), (r_, x_))
        with span("register.update"):
            n_plateaus, lr_scale = st["n_plateaus"], st["lr_scale"]
            live = n_plateaus < cfg.max_n_plateaus
            rot, xyz = r_.detach(), x_.detach()
            loss = sims.detach()

            def adam(p, m, v, g, lr):
                m = _B1 * m + (1 - _B1) * g
                v = _B2 * v + (1 - _B2) * g * g
                m_hat, v_hat = clock.unbias(m, v)
                return p + lr[:, None] * m_hat / (torch.sqrt(v_hat) + _EPS), m, v

            def frozen(new, old):
                return torch.where(live[:, None], new, old)

            # lr warmup: fresh Adam moments move a full +-lr per component on
            # the first steps; ramp them in
            warm = clock.warm()
            lr_r = cfg.lr_rot * lr_scale * warm
            lr_x = cfg.lr_xyz * lr_scale * warm
            m_r, v_r, m_x, v_x = st["m_r"], st["v_r"], st["m_x"], st["v_x"]
            rot2, m_r2, v_r2 = adam(rot, m_r, v_r, g_r, lr_r)
            xyz2, m_x2, v_x2 = adam(xyz, m_x, v_x, g_x, lr_x)
            rot2, m_r2, v_r2 = frozen(rot2, rot), frozen(m_r2, m_r), frozen(v_r2, v_r)
            xyz2, m_x2, v_x2 = frozen(xyz2, xyz), frozen(m_x2, m_x), frozen(v_x2, v_x)

            # argmax-pose tracking (the loss is of the PRE-step pose)
            raw_improved = (loss > st["best_raw"]) & live
            best_raw = torch.where(raw_improved, loss, st["best_raw"])
            b_rot = torch.where(raw_improved[:, None], rot, st["b_rot"])
            b_xyz = torch.where(raw_improved[:, None], xyz, st["b_xyz"])

            # scheduler.step(loss); warmup iterations do not tick patience
            num_bad = st["num_bad"]
            improved = loss > st["best"] * (1.0 + cfg.threshold)
            best = torch.where(improved & live, loss, st["best"])
            ticking = live & clock.ticking()
            num_bad = torch.where(
                ticking, torch.where(improved, torch.zeros_like(num_bad), num_bad + 1), num_bad,
            )
            reduce = (num_bad > cfg.patience) & live
            lr_scale = torch.where(reduce, lr_scale * 0.1, lr_scale)
            num_bad = torch.where(reduce, torch.zeros_like(num_bad), num_bad)

            # plateau counting on observed lr drops (the initial one too)
            lr_now = cfg.lr_rot * lr_scale
            dropped = (lr_now < st["current_lr"]) & live
            current_lr = torch.where(dropped, lr_now, st["current_lr"])
            n_plateaus = n_plateaus + dropped.to(n_plateaus.dtype)
            newly_done = (n_plateaus >= cfg.max_n_plateaus) & live
            done_itr = torch.where(newly_done, clock.itr(st["done_itr"]), st["done_itr"])

            # record (pose after the step, similarity before it)
            pose2 = convert(rot2, xyz2, parameterization=cfg.parameterization,
                            convention=cfg.convention)
            e_rot, e_xyz = pose2.convert("euler_angles", "ZXY")
            traj, nccs, lrs = self.rec
            clock.record(traj, torch.cat([e_rot.reshape(K, -1)[:, :3],
                                          e_xyz.reshape(K, -1)[:, :3]], 1))
            clock.record(nccs, loss)
            clock.record(lrs, torch.stack([lr_r, lr_x], dim=1))
        return dict(rot=rot2, xyz=xyz2, m_r=m_r2, v_r=v_r2, m_x=m_x2, v_x=v_x2,
                    b_rot=b_rot, b_xyz=b_xyz, best_raw=best_raw, best=best, num_bad=num_bad,
                    lr_scale=lr_scale, current_lr=current_lr, n_plateaus=n_plateaus,
                    done_itr=done_itr)

    def _step(self) -> None:
        new = self.iterate()
        with span("register.update"):
            for k, v in new.items():
                self.st[k].copy_(v)
            self.clock.advance()

    def step(self) -> int:
        """One iteration on the buffers -> 1 if it was a graph replay."""
        if not self.cfg.graphed:
            self._step()
            return 0
        return self._replay()

    def _replay(self) -> int:
        if self.graph is None:
            if self.stream is None:
                self.stream = torch.cuda.Stream(self.gt.device)
            cur = torch.cuda.current_stream(self.stream.device)
            self.stream.wait_stream(cur)
            if not self.warmed:
                with torch.cuda.stream(self.stream):
                    self._step()
                cur.wait_stream(self.stream)
                self.warmed = True
                return 0
            graph = torch.cuda.CUDAGraph()
            with _cuda.captured() as self.launches:
                with torch.cuda.graph(graph, stream=self.stream):
                    self._step()
            cur.wait_stream(self.stream)
            count("register.graph_captures")
            self.graph = graph
        with span("register.replay"):
            self.graph.replay()
        _cuda.replayed(self.launches)
        return 1

    def finish(self, i: int):
        """The loop records PRE-step losses, so the final iterate was never
        scored: score it and keep, per image, the better of (last, argmax)
        -> (rot, xyz, iterations run, *records, final similarity)."""
        cfg, st = self.cfg, self.st
        with torch.no_grad():
            with span("register.render"):
                img = self._rendered(st["rot"], st["xyz"])
            with span("register.similarity"):
                last_ncc = cfg.imagesim(self.gt, cfg.transform(img))
        with span("register.update"):
            use_last = last_ncc >= st["best_raw"]
            rot_out = torch.where(use_last[:, None], st["rot"], st["b_rot"])
            xyz_out = torch.where(use_last[:, None], st["xyz"], st["b_xyz"])
            final_ncc = torch.maximum(last_ncc, st["best_raw"])
            n_done = torch.clamp(st["done_itr"], max=i)
        return rot_out, xyz_out, n_done, *self.rec, final_ncc


class RegistrarBase:
    """Shared machinery for all initial-pose strategies."""

    def __init__(
        self,
        volume,
        mask=None,
        orientation: str | None = "AP",
        labels=None,
        crop: int = 0,
        subtract_background: bool = False,
        linearize: bool = False,
        equalize: bool = False,
        reducefn="max",
        scales: str = "8",
        n_itrs: str = "500",
        reverse_x_axis: bool = False,
        renderer: str = "trilinear",
        parameterization: str = "euler_angles",
        convention: str | None = "ZXY",
        voxel_shift: float = 0.0,
        lr_rot: float = 1e-2,
        lr_xyz: float = 1e0,
        patience: int = 10,
        threshold: float = 1e-4,
        max_n_plateaus: int = 3,
        max_restarts: int = 1,
        restart_seeds: int = 4,
        restart_jitter_rot: float = 1.0,
        restart_jitter_xyz: float = 4.0,
        coarse_seeds: int = 0,
        coarse_jitter_rot: float = 3.0,
        coarse_jitter_xyz: float = 10.0,
        init_only: bool = False,
        saveimg: bool = False,
        verbose: int = 1,
        read_kwargs: dict | None = None,
        drr_kwargs: dict | None = None,
        save_kwargs: dict | None = None,
        stage_warmup: int = 5,
        mesh=None,
        device="cuda",
    ):
        # optional device mesh: a batched registration splits its renders over
        # the slots (pure data parallelism, or rows of one render); the
        # registrar then lives on the first slot's device
        self.mesh = mesh
        self.device = mesh.first if mesh is not None else torch.device(device)
        self.volume = volume
        self.mask = mask
        self.orientation = orientation
        self.labels = labels
        self.reverse_x_axis = reverse_x_axis
        self.renderer = renderer
        self.read_kwargs = read_kwargs or {}
        self.drr_kwargs = dict(drr_kwargs or {})
        self.drr_kwargs["voxel_shift"] = voxel_shift

        self.crop = crop
        self.subtract_background = subtract_background
        self.linearize = linearize
        self.equalize = equalize
        self.reducefn = reducefn

        self.parameterization = parameterization
        self.convention = convention

        self.scales = scales.split(",") if isinstance(scales, str) else list(scales)
        self.n_itrs = [int(n) for n in (n_itrs.split(",") if isinstance(n_itrs, str) else n_itrs)]
        if len(self.scales) != len(self.n_itrs):
            raise ValueError("scales and n_itrs must align")

        self.lr_rot = lr_rot
        self.lr_xyz = lr_xyz
        self.patience = patience
        self.threshold = threshold
        self.max_n_plateaus = max_n_plateaus
        self.max_restarts = max_restarts
        self.restart_seeds = max(1, int(restart_seeds))
        self.restart_jitter_rot = restart_jitter_rot
        self.restart_jitter_xyz = restart_jitter_xyz
        self.coarse_seeds = int(coarse_seeds or 0)
        self.coarse_jitter_rot = coarse_jitter_rot
        self.coarse_jitter_xyz = coarse_jitter_xyz

        self.init_only = init_only
        self.saveimg = saveimg
        self.verbose = verbose
        self.stage_warmup = stage_warmup
        self.save_kwargs = save_kwargs or {}
        # one record per stage run: detector, iterations, wall time
        self.stage_log: list[dict] = []
        # the graphed stages by their settings, least recently used first
        self._stage_graphs: dict[_Settings, _Stage] = {}

        self.projector = initialize_drr(
            volume,
            mask,
            labels=self.labels,
            orientation=orientation,
            x0=0.0,
            y0=0.0,
            reverse_x_axis=reverse_x_axis,
            # "<family>_exact" pins the golden renderer: the suffix opts out
            # of the kernel upgrade in run_batch
            renderer=renderer.removesuffix("_exact"),
            read_kwargs=self.read_kwargs,
            drr_kwargs=self.drr_kwargs,
            device=self.device,
            **PLACEHOLDER,
        )

    # ------------------------------------------------------------------
    def initialize_pose(self, i2d):
        """-> (gt, sdd, delx, dely, x0, y0, pf_to_af, init_pose)."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    def _stage(self, cfg: _Settings, rot, xyz, gt, prepared) -> _Stage:
        """The stage of ``cfg``: where graphed, the cached one, made when there
        is none with the prepared-volume buffer of a cached stage whose volume
        has the same shape (stages run one at a time, so they may share it),
        the least recently used of more than ``_MAX_STAGE_GRAPHS`` dropped;
        elsewhere a new one over ``gt`` and ``prepared`` themselves."""
        if not cfg.graphed:
            return _Stage(cfg, rot, xyz, gt, prepared)
        stages = self._stage_graphs
        entry = stages.pop(cfg, None)
        if entry is None:
            shared = next((e.prepared for e in stages.values()
                           if e.prepared.vol.shape == prepared.vol.shape), None)
            entry = _Stage(cfg, rot, xyz, torch.empty_like(gt),
                           prepared.empty_like() if shared is None else shared)
            if len(stages) >= _MAX_STAGE_GRAPHS:
                stages.pop(next(iter(stages)))
        stages[cfg] = entry
        return entry

    # ------------------------------------------------------------------
    def _make_stage(self, projector: Projector, n_itr: int, mncc_patch_size, gncc_patch_size,
                    sigma, beta):
        """One pyramid stage as a function of (rot, xyz, gt, density, lr_rot,
        lr_xyz), plus the X-ray transform of its detector. The stage runs its
        iterations on a :class:`_Stage`'s buffers: where
        :func:`_graphs_engage`, each one replay of a CUDA graph (the stage
        cached on the registrar), elsewhere op by op."""
        H, W = projector.detector.height, projector.detector.width
        transform = make_xray_transforms(H, W, use_equalize=self.equalize)
        imagesim = make_imagesim(mncc_patch_size, gncc_patch_size, sigma, beta)
        rows = max(_GRAPH_ROWS, 1 << max(n_itr - 1, 0).bit_length())

        def stage(rot, xyz, gt, density, lr_rot, lr_xyz):
            with span("register.buffers"):  # the stage's start into its buffers
                prepared = projector.prepare(density)
                cfg = _Settings(
                    projector=projector, mesh=self.mesh, transform=transform, imagesim=imagesim,
                    volume=id(projector.volume), view=projector.replace(volume=None, density=None),
                    shapes=(tuple(rot.shape), tuple(gt.shape)), rows=rows,
                    lr_rot=float(lr_rot), lr_xyz=float(lr_xyz),
                    similarity=(mncc_patch_size, gncc_patch_size, sigma, beta),
                    equalize=self.equalize, parameterization=self.parameterization,
                    convention=self.convention, patience=self.patience, threshold=self.threshold,
                    max_n_plateaus=self.max_n_plateaus, warmup=float(self.stage_warmup),
                    graphed=_graphs_engage(projector, self.mesh, self.parameterization),
                )
                s = self._stage(cfg, rot, xyz, gt, prepared)
                s.load(rot, xyz, gt, density, prepared, n_itr)
                del prepared
            i = replays = 0
            while s.running(i, n_itr):
                replays += s.step()
                count("register.iterations")
                i += 1
            count("register.graph_replays", replays)
            rot_out, xyz_out, n_done, *records, final_ncc = s.finish(i)
            with span("register.buffers"):  # the records out of them
                records = tuple(r[:n_itr].clone() for r in records)
            return (rot_out, xyz_out, n_done, *records, final_ncc)

        return stage, transform

    # ------------------------------------------------------------------
    def run_test_time_optimization(self, gt, init_pose, scales, imagesim_cfg):
        """Multiscale refinement batched over K X-rays: every pyramid stage
        renders all K poses in one batched call per iteration.

        -> (final_pose [K poses], params_rows, nccs, times, alphas — each a
        length-K list of per-image records)"""
        with span("register.prepare"):
            rot, xyz = init_pose.convert(self.parameterization, self.convention)
            K = gt.shape[0]
            if rot.shape[0] != K:
                raise ValueError(f"{rot.shape[0]} poses for {K} X-rays")

            e_rot, e_xyz = init_pose.convert("euler_angles", "ZXY")
            e0 = np.concatenate(
                [_host(e_rot).reshape(K, -1)[:, :3], _host(e_xyz).reshape(K, -1)[:, :3]], axis=1
            )
        params_rows = [[e0[k].tolist()] for k in range(K)]
        nccs: list[list[float]] = [[] for _ in range(K)]
        times: list[list[float]] = [[0.0] for _ in range(K)]
        alphas = [[[self.lr_rot, self.lr_xyz]] for _ in range(K)]

        step_size_scalar = 1.0
        final_ncc = None
        for stage_idx, (scale, n_itr) in enumerate(zip(scales, self.n_itrs), start=1):
            with span("register.prepare"):
                proj = self.projector.rescale_detector(scale)
                stage_fn, transform = self._make_stage(proj, n_itr, *imagesim_cfg)
                gt_stage = transform(gt)
            step_size_scalar *= 2 ** (stage_idx - 1)
            lr_rot = self.lr_rot / step_size_scalar
            lr_xyz = self.lr_xyz / step_size_scalar

            if proj.device.type == "cuda":
                torch.cuda.synchronize(proj.device)
            with span("register.stage"):
                t0 = time.perf_counter()
                rot, xyz, n_done, traj, stage_nccs, stage_lrs, final_ncc = stage_fn(
                    rot, xyz, gt_stage, proj.density, lr_rot, lr_xyz
                )
                n_done, traj, stage_nccs, stage_lrs = map(_host,
                                                          (n_done, traj, stage_nccs, stage_lrs))
                t1 = time.perf_counter()

            per_itr = (t1 - t0) / max(int(n_done.max()), 1)
            self.stage_log.append(dict(
                stage=stage_idx, K=K, height=proj.detector.height, width=proj.detector.width,
                renderer=proj.renderer, perm=proj.pallas_perm, n_done=int(n_done.max()),
                seconds=t1 - t0,
                ms_per_itr=per_itr * 1e3,
            ))
            for k in range(K):
                nk = int(n_done[k])
                params_rows[k].extend(traj[:nk, k].tolist())
                nccs[k].extend(stage_nccs[:nk, k].tolist())
                times[k].extend([per_itr] * nk)
                alphas[k].extend(stage_lrs[:nk, k].tolist())
            if self.verbose > 0:
                done_str = "/".join(str(int(n)) for n in n_done)
                ncc_str = "/".join(f"{float(v):.4f}" for v in _host(final_ncc))
                print(
                    f"Stage {stage_idx}: {done_str}/{n_itr} itrs @ {proj.detector.height}x"
                    f"{proj.detector.width}, ncc={ncc_str}, {per_itr * 1e3:.1f} ms/itr",
                    flush=True,
                )

        fin = _host(final_ncc)
        for k in range(K):
            nccs[k].append(float(fin[k]))
        with span("register.prepare"):
            final_pose = convert(rot, xyz, parameterization=self.parameterization,
                                 convention=self.convention)
        return final_pose, params_rows, nccs, times, alphas

    # ------------------------------------------------------------------
    def run(self, i2d, mncc_patch_size=9, gncc_patch_size=11, sigma=0.0, beta=0.5):
        """Register ONE X-ray (= the K=1 case of :meth:`run_batch`)."""
        return self.run_batch([i2d], mncc_patch_size, gncc_patch_size, sigma, beta)[0]

    # ------------------------------------------------------------------
    def _upgrades(self) -> bool:
        """Whether :meth:`_upgrade_renderer` may choose the kernels."""
        return self.renderer in ("trilinear", "siddon") and kernel_upgrade_allowed(self.device)

    def _upgrade_renderer(self, scales, init_pose, rotations) -> None:
        """Kernel selection, made afresh for every optimization from the
        configured renderer (never from an earlier batch's choice): on a CUDA
        device (or with XVR_FORCE_SHEARWARP, which the CPU tests set) the bare
        ``trilinear``/``siddon`` renderers become ``{family}_fast`` when
        shear-warp accepts the coarse stage's rays; a ``trilinear`` renderer
        that is left (shear-warp declined, or ``XVR_NO_SHEARWARP``) becomes
        ``trilinear_pallas`` when the slab kernels accept them.
        ``XVR_NO_PALLAS`` disables every upgrade. The permutation is that of
        the poses' mean rotation, from ``rotations`` (their oriented
        rotations, already on the host).

        The JAX package chooses once per batch from the mean rotation of all
        its X-rays, and from the projector the previous batch left: a batch
        whose views march different volume axes (a biplane pair) falls to
        the golden renderer, and a batch that the steepness check declines
        keeps the previous batch's permutation. The port gives each march axis
        of a batch an optimization of its own (:meth:`_run_batch`) and chooses
        here from ``self.renderer``."""
        if not self._upgrades():
            return
        self.projector = self.projector.replace(renderer=self.renderer, pallas_perm=None)
        if not os.environ.get("XVR_NO_SHEARWARP"):
            coarse = self.projector.rescale_detector(scales[0]).with_shearwarp(
                probe_poses=init_pose, rotations=rotations)
            if coarse.renderer.endswith("_fast"):
                self.projector = self.projector.replace(
                    renderer=coarse.renderer,
                    pallas_perm=coarse.pallas_perm,
                    pallas_window=coarse.pallas_window,
                    pallas_remap=False,
                    shearwarp_remap=coarse.shearwarp_remap,
                )
        if self.projector.renderer == "trilinear":
            coarse = self.projector.rescale_detector(scales[0]).with_pallas(
                probe_poses=init_pose, rotations=rotations)
            if coarse.renderer == "trilinear_pallas":
                self.projector = self.projector.replace(
                    renderer="trilinear_pallas",
                    pallas_perm=coarse.pallas_perm,
                    pallas_window=coarse.pallas_window,
                )

    def run_batch(self, i2ds, mncc_patch_size=9, gncc_patch_size=11, sigma=0.0, beta=0.5):
        """Register K X-rays sharing intrinsics, one batched optimization per
        march axis among their initial poses (one for every batch whose views
        march one volume axis). Returns a list of K per-image result tuples,
        each shaped like a :meth:`run` result, in input order."""
        with span("register.request", request=True):
            return self._run_batch(i2ds, mncc_patch_size, gncc_patch_size, sigma, beta)

    def _run_batch(self, i2ds, mncc_patch_size, gncc_patch_size, sigma, beta):
        with span("register.read"):
            inits = [self.initialize_pose(i2d) for i2d in i2ds]
            intrs = [tuple(float(v) for v in x[1:6]) for x in inits]  # sdd..y0
            shapes = [tuple(x[0].shape[-2:]) for x in inits]
            if len(set(intrs)) != 1 or len(set(shapes)) != 1:
                raise ValueError(
                    "run_batch requires every X-ray to share intrinsics and shape; got (sdd, delx, "
                    f"dely, x0, y0) in {sorted(set(intrs))} and shapes {sorted(set(shapes))}"
                )
            sdd, delx, dely, x0, y0 = intrs[0]
            pf_to_afs = [x[6] for x in inits]
            host_sync(self.device, len(inits))
            gt = torch.cat([torch.as_tensor(x[0], device=self.device) for x in inits], dim=0)
            init_pose = RigidTransform(
                torch.cat([x[7].matrix.reshape(-1, 4, 4).to(self.device) for x in inits], dim=0)
            )
        H, W = gt.shape[-2:]
        intrinsics = dict(sdd=sdd, height=H, width=W, delx=delx, dely=dely, x0=-x0, y0=y0)
        scales = _parse_scales(self.scales, self.crop, H)
        K = gt.shape[0]
        rotations, groups = None, [list(range(K))]
        with span("register.prepare"):
            self.projector = self.projector.set_intrinsics(**intrinsics)
            if self._upgrades():  # the kernels march one axis: an optimization per axis
                rotations = self.projector.oriented_rotations(init_pose)
                groups = _march_groups(rotations, self.projector.affine_inverse_host())
        results = [None] * K
        for idx in groups:
            count("register.perm_groups")
            out = self._optimize(_rows(gt, idx), RigidTransform(_rows(init_pose.matrix, idx)),
                                 None if rotations is None else rotations[idx],
                                 [pf_to_afs[k] for k in idx], intrinsics, scales,
                                 (mncc_patch_size, gncc_patch_size, sigma, beta))
            for k, res in zip(idx, out):
                results[k] = res
        return results

    def _optimize(self, gt, init_pose, rotations, pf_to_afs, intrinsics, scales, imagesim_cfg):
        """One batched optimization of the X-rays ``gt`` from ``init_pose``
        (their oriented ``rotations`` on the host), whose views march one
        volume axis: the renderer's choice, the optional coarse sweep, pass 1
        and the re-anneal passes. -> one result tuple per X-ray."""
        n = K = gt.shape[0]
        if self.mesh is not None and K % self.mesh.size and K * self.restart_seeds >= self.mesh.size:
            # pad to a full set of slots with repeats of the last X-ray (their
            # results are computed and dropped); a batch too small to fill
            # the mesh is not padded: its renders are split by rows instead
            pad = self.mesh.size - K % self.mesh.size
            gt = torch.cat([gt] + [gt[-1:]] * pad)
            init_pose = RigidTransform(torch.cat([init_pose.matrix] + [init_pose.matrix[-1:]] * pad))
            if rotations is not None:
                rotations = np.concatenate([rotations] + [rotations[-1:]] * pad)
            pf_to_afs = pf_to_afs + [pf_to_afs[-1]] * pad
            K = gt.shape[0]
        with span("register.prepare"):
            self._upgrade_renderer(scales, init_pose, rotations)

        if self.init_only:
            return [
                (gt[k : k + 1], intrinsics, self.projector.rescale_detector(scales[0]),
                 init_pose[k : k + 1], None, dict(pf_to_af=pf_to_afs[k]))
                for k in range(n)
            ]

        t0 = time.perf_counter()
        S = self.restart_seeds
        with span("register.prepare"):
            gt_ms = torch.repeat_interleave(gt, S, dim=0) if S > 1 else gt

        def _seed_poses(base_pose, pass_idx, n_seeds=None, jitter_rot=None, jitter_xyz=None):
            """Seed k*S of each image is the unperturbed pose; the rest add
            one shared (n_seeds-1, 3) jitter table seeded by the pass index."""
            with span("register.seed"):
                n_seeds = S if n_seeds is None else n_seeds
                jitter_rot = self.restart_jitter_rot if jitter_rot is None else jitter_rot
                jitter_xyz = self.restart_jitter_xyz if jitter_xyz is None else jitter_xyz
                e_rot, e_xyz = base_pose.convert("euler_angles", "ZXY")
                rot_s = np.repeat(_host(e_rot).reshape(K, -1)[:, :3], n_seeds, axis=0)
                xyz_s = np.repeat(_host(e_xyz).reshape(K, -1)[:, :3], n_seeds, axis=0)
                if n_seeds > 1:
                    prng = np.random.default_rng(1000 + pass_idx)
                    jit = (np.arange(K * n_seeds) % n_seeds) != 0
                    j_rot = np.deg2rad(prng.uniform(-jitter_rot, jitter_rot, (n_seeds - 1, 3)))
                    j_xyz = prng.uniform(-jitter_xyz, jitter_xyz, (n_seeds - 1, 3))
                    rot_s[jit] += np.tile(j_rot, (K, 1))
                    xyz_s[jit] += np.tile(j_xyz, (K, 1))
                host_sync(self.device, 2)
                return convert(
                    torch.as_tensor(rot_s, dtype=torch.float32, device=self.device),
                    torch.as_tensor(xyz_s, dtype=torch.float32, device=self.device),
                    "euler_angles", "ZXY",
                )

        def _select(r_nccs):
            """Per-image argmax over seeds; a jittered start must beat the
            unperturbed one by the plateau threshold."""
            fin = np.asarray([r_nccs[j][-1] for j in range(K * S)]).reshape(K, S)
            handicapped = fin.copy()
            handicapped[:, 1:] -= self.threshold
            best_s = handicapped.argmax(axis=1)
            return best_s, fin[np.arange(K), best_s]

        # ---- wide coarse-stage multi-start (optional basin search) --------
        iters_pre = 0
        Sc = self.coarse_seeds
        if 0 < Sc <= S:
            warnings.warn(
                f"coarse_seeds={Sc} <= restart_seeds={S} is a no-op: the "
                f"coarse sweep only runs when it is wider than the starts "
                f"kept for the full pyramid (set coarse_seeds > {S} to "
                f"enable it)",
                stacklevel=2,
            )
        if Sc > S and self.n_itrs:
            gt_c = torch.repeat_interleave(gt, Sc, dim=0) if Sc > 1 else gt
            c_pose, _, c_nccs, _, _ = self.run_test_time_optimization(
                gt_c,
                _seed_poses(init_pose, 555, Sc, self.coarse_jitter_rot, self.coarse_jitter_xyz),
                scales[:1], imagesim_cfg,
            )
            iters_pre = max(len(c_nccs[j]) - 1 for j in range(K * Sc))
            fin_c = np.asarray([c_nccs[j][-1] for j in range(K * Sc)]).reshape(K, Sc)
            with span("register.seed"):
                mats_c = _host(c_pose.matrix).reshape(K, Sc, 4, 4)
                starts = np.empty((K, S, 4, 4), np.float32)
                for k in range(K):
                    order = 1 + np.argsort(-fin_c[k, 1:])  # best jittered first
                    starts[k] = mats_c[k, [0] + order[: S - 1].tolist()]
                pass1_starts = RigidTransform(torch.as_tensor(starts.reshape(K * S, 4, 4),
                                                              device=self.device))
            if self.verbose > 0:
                spread = "/".join(f"{fin_c[k].max() - fin_c[k, 0]:+.4f}" for k in range(K))
                print(f"Coarse sweep ({Sc} seeds): best-vs-exact ncc {spread}", flush=True)
        else:
            pass1_starts = _seed_poses(init_pose, 999)

        # ---- pass 1: multi-start from the initial poses -------------------
        r_pose, r_params, r_nccs, r_times, r_alphas = self.run_test_time_optimization(
            gt_ms, pass1_starts, scales, imagesim_cfg
        )
        best_s, _ = _select(r_nccs)
        sel = np.arange(K) * S + best_s
        with span("register.seed"):
            host_sync(r_pose.matrix)  # the host's index, copied to the device
            final_pose = RigidTransform(r_pose.matrix.reshape(K * S, 4, 4)[torch.as_tensor(sel)])
        params, nccs, times, alphas = [], [], [], []
        for k in range(K):
            j = int(k * S + best_s[k])
            params.append(list(r_params[j]))
            nccs.append(list(r_nccs[j]))
            times.append(list(r_times[j]))
            alphas.append(list(r_alphas[j]))
        iters_run = iters_pre + max(len(r_nccs[j]) - 1 for j in range(K * S))

        # ---- objective-gated re-anneal passes ------------------------------
        for restart_idx in range(self.max_restarts):
            prev_ncc = np.asarray([nccs[k][-1] for k in range(K)])
            r_pose, r_params, r_nccs, r_times, r_alphas = self.run_test_time_optimization(
                gt_ms, _seed_poses(final_pose, restart_idx), scales, imagesim_cfg
            )
            best_s, new_ncc = _select(r_nccs)
            iters_run += max(len(r_nccs[j]) - 1 for j in range(K * S))
            improved = new_ncc > prev_ncc
            if improved.any():
                with span("register.seed"):
                    mats = _host(final_pose.matrix).reshape(K, 4, 4).copy()
                    r_mats = _host(r_pose.matrix).reshape(K * S, 4, 4)
                    sel = np.arange(K) * S + best_s
                    mats[improved] = r_mats[sel[improved]]
                    host_sync(self.device)
                    final_pose = RigidTransform(torch.as_tensor(mats, device=self.device))
                for k in np.flatnonzero(improved):
                    # when the unperturbed seed wins, its row 0 repeats the
                    # trajectory's current tail: drop it
                    j = int(k * S + best_s[k])
                    skip = 1 if best_s[k] == 0 else 0
                    params[k].extend(r_params[j][skip:])
                    nccs[k].extend(r_nccs[j][skip:])
                    times[k].extend(r_times[j][skip:])
                    alphas[k].extend(r_alphas[j][skip:])
            if self.verbose > 0:
                print(
                    f"Restart pass {restart_idx + 1}: improved {int(improved.sum())}/{K} images",
                    flush=True,
                )
            if not (new_ncc > prev_ncc + self.threshold).any():
                break
        runtime = time.perf_counter() - t0
        results = []
        for k in range(K):
            trajectory = dict(
                params=np.asarray(params[k], dtype=np.float64),
                ncc=np.asarray(nccs[k], dtype=np.float64),
                times=np.asarray(times[k], dtype=np.float64),
                lrs=np.asarray(alphas[k], dtype=np.float64),
            )
            kwargs = dict(pf_to_af=pf_to_afs[k], runtime=runtime, trajectory=trajectory,
                          iters_run=iters_run)
            if K > 1:
                kwargs["batch_size"] = K
            results.append(
                (gt[k : k + 1], intrinsics, self.projector,
                 init_pose[k : k + 1], final_pose[k : k + 1], kwargs)
            )
        return results[:n]

    # ------------------------------------------------------------------
    def register_files(self, i2ds, outpath, mncc_patch_size: int = 9, gncc_patch_size: int = 11,
                       sigma: float = 0.0, beta: float = 0.5, max_batch: int = 8):
        """Register many X-rays, batching runs that share intrinsics (by their
        DICOM headers); one bundle per X-ray, in input order."""
        from ..io.xray import dicom_group_key

        i2ds = [Path(p) for p in i2ds]
        groups: dict[tuple, list[Path]] = {}
        for p in i2ds:
            groups.setdefault(dicom_group_key(p), []).append(p)
        saved = {}
        for files in groups.values():
            for c0 in range(0, len(files), max_batch):
                chunk = files[c0 : c0 + max_batch]
                results = self.run_batch(chunk, mncc_patch_size, gncc_patch_size, sigma, beta)
                for i2d, result in zip(chunk, results):
                    saved[i2d] = self._save_result(i2d, outpath, result)
        return [saved[p] for p in i2ds]

    def __call__(self, i2d, outpath, mncc_patch_size: int = 9, gncc_patch_size: int = 11,
                 sigma: float = 0.0, beta: float = 0.5):
        result = self.run(i2d, mncc_patch_size, gncc_patch_size, sigma, beta)
        return self._save_result(Path(i2d), outpath, result)

    def _save_result(self, i2d, outpath, result):
        with span("register.save"):
            savepath = Path(outpath) / Path(i2d).stem
            savepath.mkdir(parents=True, exist_ok=True)
            gt, intrinsics, proj, init_pose, final_pose, kwargs = result
            init_img = final_img = None
            if self.saveimg:
                scaled = proj.rescale_detector(max(intrinsics["height"] // 256, 1))
                with torch.no_grad():
                    init_img = _host(scaled(init_pose))
                    if final_pose is not None:
                        final_img = _host(scaled(final_pose))
            self.save(savepath, gt, init_img, final_img, i2d, intrinsics, init_pose, final_pose,
                      kwargs)
            return savepath

    # ------------------------------------------------------------------
    def save(self, savepath, gt, init_img, final_img, i2d, intrinsics, init_pose, final_pose, kwargs):
        """Persist the result bundle, byte-compatible with the JAX package's:
        ``parameters.npz`` (poses + trajectory), ``parameters.json`` (full
        config), ``trajectory.csv``, optional PNG renders."""
        savepath = Path(savepath)
        mask = str(Path(self.mask).resolve()) if self.mask is not None else None
        meta = {
            "drr": {
                "volume": str(Path(self.volume).resolve()),
                "mask": mask,
                "labels": self.labels,
                "orientation": self.orientation,
                **{k: float(v) if isinstance(v, (int, float)) else v for k, v in intrinsics.items()},
                "reverse_x_axis": self.reverse_x_axis,
                "renderer": self.renderer,
                "read_kwargs": self.read_kwargs,
                "drr_kwargs": self.drr_kwargs,
            },
            "xray": {
                "filename": str(Path(i2d).resolve()),
                "crop": self.crop,
                "subtract_background": self.subtract_background,
                "linearize": self.linearize,
                "reducefn": self.reducefn if not callable(self.reducefn) else "custom",
            },
            "optimization": {
                "equalize": self.equalize,
                "init_only": self.init_only,
                "scales": self.scales,
                "n_itrs": self.n_itrs,
                "parameterization": self.parameterization,
                "convention": self.convention,
                "lr_rot": self.lr_rot,
                "lr_xyz": self.lr_xyz,
                "patience": self.patience,
                "max_n_plateaus": self.max_n_plateaus,
                "max_restarts": self.max_restarts,
                "restart_seeds": self.restart_seeds,
                "restart_jitter_rot": self.restart_jitter_rot,
                "restart_jitter_xyz": self.restart_jitter_xyz,
                "coarse_seeds": self.coarse_seeds,
                "coarse_jitter_rot": self.coarse_jitter_rot,
                "coarse_jitter_xyz": self.coarse_jitter_xyz,
            },
            **{k: v for k, v in self.save_kwargs.items()},
            "pf_to_af": bool(kwargs.get("pf_to_af", False)),
        }
        if "runtime" in kwargs:
            meta["runtime"] = float(kwargs["runtime"])
        if "iters_run" in kwargs:
            meta["iters_run"] = int(kwargs["iters_run"])
        if "batch_size" in kwargs:
            meta["batch_size"] = int(kwargs["batch_size"])

        arrays = {"init_pose": _host(init_pose.matrix)}
        if final_pose is not None:
            arrays["final_pose"] = _host(final_pose.matrix)
        traj = kwargs.get("trajectory")
        if traj is not None:
            arrays.update({f"trajectory_{k}": v for k, v in traj.items()})
            self._write_csv(savepath / "trajectory.csv", traj)
        np.savez(savepath / "parameters.npz", **arrays)
        (savepath / "parameters.json").write_text(json.dumps(meta, indent=2, default=str))

        if self.saveimg:
            self._save_png(savepath / "gt.png", _host(gt))
            if init_img is not None:
                self._save_png(savepath / "init_img.png", init_img)
            if final_img is not None:
                self._save_png(savepath / "final_img.png", final_img)

    @staticmethod
    def _write_csv(path, traj):
        cols = ["r1", "r2", "r3", "tx", "ty", "tz", "ncc", "times", "lr_rot", "lr_xyz"]
        params = traj["params"]
        ncc = traj["ncc"][: len(params)]
        times = traj["times"][: len(params)]
        lrs = traj["lrs"][: len(params)]
        with open(path, "w") as f:
            f.write(",".join(cols) + "\n")
            for i in range(len(params)):
                row = list(params[i]) + [ncc[i] if i < len(ncc) else np.nan, times[i]] + list(lrs[i])
                f.write(",".join(f"{v:.8g}" for v in row) + "\n")

    @staticmethod
    def _save_png(path, img):
        img = np.asarray(img, dtype=np.float64).squeeze()
        if img.ndim == 3:
            img = img[0]
        lo, hi = img.min(), img.max()
        img8 = ((img - lo) / (hi - lo + 1e-12) * 255).astype(np.uint8)
        try:
            import imageio.v3 as iio

            iio.imwrite(path, img8)
        except ImportError:
            np.save(str(path) + ".npy", img8)
