"""Pose-regression training engine: counterpart of ``xvr_tpu.train.trainer``.

One step samples poses per alpha stratum (shifted to the volume centre),
maps the CT to attenuation with a random bone contrast, renders the target
DRRs, keeps the samples that view enough of the scene (``keep`` weights
instead of filtering, as in the JAX package), augments and normalizes them
for the CNN, re-renders at the predicted poses (each in its target's
stratum), and takes the AGC-clipped Adam step of :mod:`.optim` on the
composite loss. The draws come first (:meth:`Trainer.draw`); the rest of the
step is deterministic given them (:meth:`Trainer.loss_and_grads`).

Route: on a CUDA device (or on the CPU under ``XVR_FORCE_SHEARWARP=1``) the
``trilinear``/``siddon`` renderers upgrade to the shear-warp kernels K1-K4,
the alpha range split into strata where one march axis cannot cover it;
where every stratum candidate declines, ``trilinear`` falls back to the slab
kernels (K5/K6; K7/K6 with a labelmap). ``XVR_NO_PALLAS=1`` turns the upgrade off. The route, the
permutations and the strata are chosen as the JAX trainer chooses them; the
GPU kernels have no gather window, so the windows are not measured. The CNN runs in float32 (PyTorch's default TF32
convolutions on the card).

Under a device ``mesh`` (:func:`xvr_tpu_torch.parallel.make_mesh`) the batch
is a multiple of the mesh size and so is every stratum's share; each
stratum's shear-warp render splits its poses over every slot, the other
renderers split the rays over (dp, rays), and the CNN's batch splits over
every slot. The weights, the optimizer and the losses stay on the first
slot's device, which is the trainer's.
"""

from __future__ import annotations

import json
import math
import os
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch

from ..geometry import RigidTransform, convert, make_translation
from ..io.volumes import read
from ..models import PoseRegressor, init_pose_regressor
from ..parallel import batch_sharded_render, gather, ray_sharded_render, shard_batch_flat
from ..render.projector import Projector
from ..render.volume import Volume, transform_hu_to_density
from ..state import from_flax_params, to_flax_params
from ..utils.itk import get_4x4
from ..utils.transforms import make_xray_transforms
from .augmentations import apply_augmentations, draw_augmentations
from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .loss import pose_regression_loss
from .optim import AGCAdamMultiSteps
from .sampler import get_random_pose
from .schedule import identity_schedule, warmup_cosine_schedule

IMG_THRESHOLD = 0.10  # keep if >10% of pixels are nonzero
MASK_THRESHOLD = 0.05  # keep if >5% of pixels hit masked structures
_FAST = ("_fast", "_shearwarp")


def pad_volumes(volumes: list[Volume]) -> list[Volume]:
    """Pad a list of volumes at their far ends to the elementwise largest
    shape, with air (-1000 HU) and label 0; the affines are kept, so world
    geometry is unchanged."""
    target = tuple(int(x) for x in np.array([v.shape for v in volumes]).max(axis=0))
    out = []
    for v in volumes:
        pads = []
        for t, s in zip(reversed(target), reversed(v.shape)):
            pads += [0, t - s]
        data = torch.nn.functional.pad(v.data, pads, value=-1000.0)
        mask = torch.nn.functional.pad(v.mask, pads) if v.mask is not None else None
        out.append(Volume(data=data, affine=v.affine, mask=mask, orientation=v.orientation))
    return out


class Trainer:
    """Train a PoseRegressor on DRRs rendered at random poses.

    The JAX trainer's argument surface; ``num_workers``/``pin_memory`` are
    accepted and unused (the volumes stay on the device). ``device`` picks
    the device (the card unless the caller asks for the CPU); with a
    ``mesh`` the trainer runs on its first slot's device instead."""

    def __init__(
        self,
        volpath,
        maskpath,
        outpath,
        alphamin, alphamax, betamin, betamax, gammamin, gammamax,
        txmin, txmax, tymin, tymax, tzmin, tzmax,
        sdd,
        height,
        delx,
        orientation="AP",
        reverse_x_axis=False,
        renderer="trilinear",
        parameterization="quaternion_adjugate",
        convention="ZXY",
        model_name="resnet18",
        pretrained=False,
        norm_layer="groupnorm",
        unit_conversion_factor=1000.0,
        p_augmentation=0.333,
        lr=2e-4,
        weight_ncc=1.0,
        weight_geo=1e-2,
        weight_dice=1.0,
        weight_mvc=0.0,
        batch_size=116,
        n_total_itrs=1_000_000,
        n_warmup_itrs=1_000,
        n_grad_accum_itrs=4,
        n_save_every_itrs=1_000,
        disable_scheduler=False,
        ckptpath=None,
        reuse_optimizer=False,
        warp=None,
        invert=False,
        patch_size=None,
        num_workers=4,
        pin_memory=False,
        weights=None,
        seed=0,
        mesh=None,
        device="cuda",
    ):
        cfg = dict(locals())
        for k in ("self", "mesh", "device"):  # runtime choices, not checkpointed config
            cfg.pop(k)
        self.config = cfg
        self.mesh = mesh  # runtime topology, not checkpointed config
        self.device = mesh.first if mesh is not None else torch.device(device)

        # "<family>_exact" pins the golden renderers and opts out of every
        # kernel upgrade
        self.renderer_exact = renderer.endswith("_exact")
        renderer = renderer.removesuffix("_exact")

        self.outpath = Path(outpath)
        self.outpath.mkdir(parents=True, exist_ok=True)
        self.batch_size = int(batch_size)
        if mesh is not None and self.batch_size % mesh.size:
            # the batch splits exactly over every slot
            rounded = -(-self.batch_size // mesh.size) * mesh.size
            print(f"multi-chip: batch_size {self.batch_size} -> {rounded} "
                  f"(multiple of {mesh.size} devices)", flush=True)
            self.batch_size = rounded
            cfg["batch_size"] = rounded
        self.height = int(height)
        self.n_total_itrs = int(n_total_itrs)
        self.n_grad_accum_itrs = int(n_grad_accum_itrs)
        self.n_save_every_itrs = int(n_save_every_itrs)
        self.sdd = float(sdd)
        self.p_augmentation = float(p_augmentation)
        self.pose_ranges = dict(
            alphamin=alphamin, alphamax=alphamax, betamin=betamin, betamax=betamax,
            gammamin=gammamin, gammamax=gammamax, txmin=txmin, txmax=txmax,
            tymin=tymin, tymax=tymax, tzmin=tzmin, tzmax=tzmax,
        )
        self.loss_weights = dict(
            weight_ncc=weight_ncc, weight_geo=weight_geo,
            weight_dice=weight_dice, weight_mvc=weight_mvc,
        )
        self.rng = np.random.default_rng(seed)  # subjects and patch crops
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))

        # ---- subjects ----
        self.subject_weights = weights
        self.patch_size = tuple(int(x) for x in patch_size) if patch_size is not None else None
        self.volumes, self.single_subject = self._initialize_subjects(volpath, maskpath, orientation)

        # ---- projectors: one per subject, then one per stratum ----
        labels = None
        if self.volumes[0].mask is not None:
            present = set()
            for v in self.volumes:
                present |= {int(x) for x in torch.unique(v.mask).tolist()}
            labels = tuple(sorted(present - {0}))
        self.labels = labels
        flat = [
            Projector.from_volume(v, sdd=sdd, height=height, delx=delx,
                                  reverse_x_axis=reverse_x_axis, renderer=renderer, labels=labels)
            for v in self.volumes
        ]
        self.centers = [v.center for v in self.volumes]
        self.strata_ranges = [dict(self.pose_ranges)]
        self.strata_counts = (self.batch_size,)
        self.projectors = [(p,) for p in flat]
        if (
            renderer in ("trilinear", "siddon")
            and not self.renderer_exact
            and (self.device.type == "cuda" or os.environ.get("XVR_FORCE_SHEARWARP"))
            and not os.environ.get("XVR_NO_PALLAS")
        ):
            self._upgrade_renderer(renderer)

        # ---- model ----
        self.model = PoseRegressor(
            model_name=model_name, parameterization=parameterization, convention=convention,
            norm_layer=norm_layer, unit_conversion_factor=unit_conversion_factor,
        )
        init_pose_regressor(self.model, torch.Generator().manual_seed(int(seed)))
        if pretrained:
            from ..models.pretrained import load_imagenet_backbone

            _, loaded = load_imagenet_backbone(self.model, model_name)
            print(
                "Loaded ImageNet backbone weights"
                if loaded
                else "pretrained=True but no ImageNet weights found (set "
                "XVR_PRETRAINED_DIR or place a torchvision state_dict in the "
                "torch hub cache); training from random init",
                flush=True,
            )
        self.model.to(self.device).train()
        self.params = dict(self.model.named_parameters())

        # ---- optimizer ----
        if disable_scheduler:
            self.schedule = identity_schedule(lr)
        else:
            self.schedule = warmup_cosine_schedule(
                lr, n_warmup_itrs / n_grad_accum_itrs, n_total_itrs / n_grad_accum_itrs
            )
        self.tx = AGCAdamMultiSteps(self.schedule, every_k=self.n_grad_accum_itrs)
        self.opt_state = self.tx.init(self.params)

        # ---- checkpoint restore (restart semantics) ----
        self.start_itr, self.model_number = 0, 0
        if ckptpath is not None:
            path = latest_checkpoint(ckptpath)
            if path is not None:
                ckpt = load_checkpoint(path)
                self.model.load_state_dict(from_flax_params(ckpt["model_state_dict"]))
                if reuse_optimizer:
                    self.opt_state = self.tx.load_state_dict(
                        ckpt["optimizer_state_dict"], from_flax_params, self.params)
                    self.start_itr = int(ckpt["itr"])
                    self.model_number = int(ckpt["model_number"])

        # ---- template -> patient reframe ----
        self.reframe = None
        if warp is not None:
            self.reframe = get_4x4(warp, volpath, invert, device=self.device)

        self.transforms = make_xray_transforms(self.height)
        self._logfile = self.outpath / "train_log.jsonl"

    # ------------------------------------------------------------------
    # route selection
    # ------------------------------------------------------------------
    @staticmethod
    def _probe_corners(
        alphamin, alphamax, betamin, betamax, gammamin, gammamax,
        txmin, txmax, tymin, tymax, tzmin, tzmax,
    ) -> RigidTransform:
        """Poses at the corners of the sampling ranges (rotation x translation
        extremes), on the host."""
        rot_corners = [[a, b, g] for a in (alphamin, alphamax) for b in (betamin, betamax)
                       for g in (gammamin, gammamax)]
        t_corners = [[txmin, tymin, tzmin], [txmax, tymin, tzmax],
                     [txmin, tymax, tzmax], [txmax, tymax, tzmin]]
        rots = torch.tensor([rc for rc in rot_corners for _ in t_corners], dtype=torch.float32)
        xyzs = torch.tensor(t_corners * len(rot_corners), dtype=torch.float32)
        return convert(rots, xyzs, "euler_angles", "ZXY", degrees=True)

    @staticmethod
    def _mean_pose(alpha, r) -> RigidTransform:
        rot = torch.tensor([[alpha, (r["betamin"] + r["betamax"]) / 2,
                             (r["gammamin"] + r["gammamax"]) / 2]], dtype=torch.float32)
        return convert(rot, torch.zeros((1, 3)), "euler_angles", "ZXY", degrees=True)

    def _upgrade_renderer(self, renderer: str) -> None:
        """Shear-warp strata if some candidate split passes, else (trilinear
        only) the slab kernels, as the JAX trainer chooses."""
        r = self.pose_ranges
        if any(self._try_shearwarp_strata(edges) for edges in self._stratum_candidates()):
            return
        if renderer == "trilinear":
            ref = self._mean_pose((r["alphamin"] + r["alphamax"]) / 2, r)
            probes = self._probe_corners(**r)
            upgraded = [p[0].with_pallas(ref, probe_poses=probes, window=48)
                        for p in self.projectors]
            perms = {p.pallas_perm for p in upgraded}
            if all(p.renderer == "trilinear_pallas" for p in upgraded) and len(perms) == 1:
                self.projectors = [(p,) for p in upgraded]
                print(f"Using the slab kernels (permutation {upgraded[0].pallas_perm})", flush=True)
            elif len(perms) > 1:
                print("Slab kernels disabled: subjects disagree on the march-axis "
                      f"permutation {sorted(perms)}", flush=True)
        if {p.renderer for tup in self.projectors for p in tup} <= {"trilinear", "siddon"}:
            print("WARNING: no kernel upgrade applied; training runs on the golden renderer "
                  "(orders of magnitude slower). Check the pose ranges / march-axis messages "
                  "above.", flush=True)

    def _stratum_candidates(self) -> list[list[float]]:
        """Candidate alpha-edge sets, best first: the whole range, a split at
        the midlines between march axes (45 + 90k degrees) without slivers,
        then uniform splits into 2-6 strata."""
        r = self.pose_ranges
        amin, amax = float(r["alphamin"]), float(r["alphamax"])
        cands: list[list[float]] = [[amin, amax]]
        x = (math.floor((amin - 45.0) / 90.0) + 1) * 90.0 + 45.0
        cross = []
        while x < amax:
            if x > amin:
                cross.append(x)
            x += 90.0
        cross = [c for c in cross if c - amin > 10.0 and amax - c > 10.0]
        if cross:
            cands.append([amin] + cross + [amax])
        for K in (2, 3, 4, 5, 6):
            cands.append([float(v) for v in np.linspace(amin, amax, K + 1)])
        return cands

    def _try_shearwarp_strata(self, edges) -> bool:
        """Split the alpha range at ``edges`` and upgrade every (stratum,
        subject) projector to shear-warp. Succeeds only if every stratum
        passes the steepness gate with one permutation shared by the
        subjects; label bounds are the union over subjects; batch shares are
        proportional to the strata's widths (largest remainder), in units of
        the mesh size under a mesh, so that every stratum splits exactly
        over the slots."""
        r = self.pose_ranges
        edges = np.asarray(edges, dtype=np.float64)
        K = len(edges) - 1
        flat = [p[0] for p in self.projectors]
        strata_projs, strata_ranges = [], []
        for lo, hi in zip(edges[:-1], edges[1:]):
            sub = dict(r)
            sub["alphamin"], sub["alphamax"] = float(lo), float(hi)
            ref = self._mean_pose((lo + hi) / 2, r)
            upgraded = [p.with_shearwarp(ref, probe_poses=self._probe_corners(**sub)) for p in flat]
            if not all(p.renderer.endswith("_fast") for p in upgraded) or \
                    len({p.pallas_perm for p in upgraded}) != 1:
                return False
            bounds = None
            bset = {p.shearwarp_bounds for p in upgraded} - {None}
            if bset:
                C = len(next(iter(bset)))
                bounds = tuple((min(b[c][0] for b in bset), max(b[c][1] for b in bset))
                               for c in range(C))
            strata_projs.append([p.replace(shearwarp_bounds=bounds) for p in upgraded])
            strata_ranges.append(sub)

        unit = 1 if self.mesh is None else self.mesh.size
        units_total = self.batch_size // unit
        widths = np.diff(edges)
        exact = widths / widths.sum() * units_total
        counts = np.floor(exact).astype(int)
        for i in np.argsort(exact - counts)[::-1][: units_total - counts.sum()]:
            counts[i] += 1
        if (counts <= 0).any():
            return False
        counts = counts * unit
        self.projectors = [tuple(strata_projs[k][s] for k in range(K)) for s in range(len(flat))]
        self.strata_ranges = strata_ranges
        self.strata_counts = tuple(int(c) for c in counts)
        desc = ", ".join(f"[{sr['alphamin']:.0f},{sr['alphamax']:.0f}]x{c}(perm {p.pallas_perm})"
                         for sr, c, p in zip(strata_ranges, self.strata_counts, self.projectors[0]))
        print(f"Using the shear-warp kernels, {K} alpha strata: {desc}", flush=True)
        return True

    def route(self) -> dict:
        """The chosen route: renderer, and per stratum its alpha range, batch
        share, permutation and label slab bounds."""
        projs = self.projectors[0]
        return dict(
            renderer=projs[0].renderer, labels=self.labels,
            strata=[dict(alpha=(sr["alphamin"], sr["alphamax"]), count=c, perm=p.pallas_perm,
                         bounds=p.shearwarp_bounds)
                    for sr, c, p in zip(self.strata_ranges, self.strata_counts, projs)],
        )

    # ------------------------------------------------------------------
    def _initialize_subjects(self, volpath, maskpath, orientation):
        volpath = Path(volpath)
        if volpath.is_file():
            return [read(volpath, maskpath, orientation=orientation, device=self.device)], True
        vols = sorted(p for p in volpath.glob("[!.]*.nii*"))
        if not vols:
            raise FileNotFoundError(f"No volumes found in {volpath}")
        masks = (sorted(Path(maskpath).glob("[!.]*.nii*")) if maskpath is not None
                 else [None] * len(vols))
        subjects = [read(v, m, orientation=orientation, device=self.device)
                    for v, m in zip(vols, masks)]
        return pad_volumes(subjects), len(subjects) == 1

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def draw(self, generator: torch.Generator | None = None) -> dict:
        """The step's random draws: ``pose`` (B, 4, 4) about the isocentre,
        stratum by stratum; ``contrast``, the bone attenuation multiplier;
        ``aug``, the augmentation draws."""
        gen = self.generator if generator is None else generator
        pose = torch.cat([
            get_random_pose(gen, batch_size=int(c), device=self.device, **r).matrix
            for r, c in zip(self.strata_ranges, self.strata_counts)
        ])
        contrast = 1.0 + 9.0 * torch.rand((), generator=gen, device=gen.device).to(self.device)
        aug = draw_augmentations(gen, (self.batch_size, 1, self.height, self.height),
                                 self.p_augmentation)
        return dict(pose=pose, contrast=contrast, aug=aug)

    def render_batch(self, projectors, pose: RigidTransform, density, packed, prepared):
        """Render the pose batch stratum by stratum -> (B, C, H, W). Under a
        mesh a shear-warp stratum splits its poses over every slot (each
        slot renders whole images: the factorization is per image), any
        other its rays over (dp, rays)."""
        offsets = np.concatenate([[0], np.cumsum(self.strata_counts)])
        imgs = []
        for k, proj in enumerate(projectors):
            pose_k = RigidTransform(pose.matrix[int(offsets[k]):int(offsets[k + 1])])
            kw = dict(density=density, packed=packed[k], prepared=prepared[k])
            if self.mesh is None:
                raw = proj.render_rays(*proj.rays(pose_k), **kw)
            elif proj.renderer.endswith(_FAST):
                raw = batch_sharded_render(self.mesh, proj, pose_k, **kw)
            else:
                raw = ray_sharded_render(self.mesh, proj, pose_k, **kw)
            imgs.append(proj.reshape_transform(raw, int(self.strata_counts[k])))
        return torch.cat(imgs) if len(imgs) > 1 else imgs[0]

    def apply_model(self, x: torch.Tensor):
        """The CNN on the batch ``x`` -> (rot, xyz). Under a mesh the batch
        splits over every slot: on one physical device the module runs per
        chunk; over several, on one replica per device, the gradients
        reduced to the first (GroupNorm keeps each image's outputs
        independent of the split)."""
        if self.mesh is None:
            return self.model(x)
        chunks = shard_batch_flat(self.mesh, x)
        devices = list(dict.fromkeys(self.mesh.slots))
        if len(devices) == 1:
            outs = [self.model(c) for c in chunks]
        else:
            replicas = dict(zip(devices, torch.nn.parallel.replicate(self.model, devices)))
            outs = torch.nn.parallel.parallel_apply(
                [replicas[d] for d in self.mesh.slots], [(c,) for c in chunks],
                devices=self.mesh.slots)
        return tuple(gather(self.mesh, parts) for parts in zip(*outs))

    def loss_and_grads(self, projectors, center, draws: dict):
        """Loss, metrics and the parameter gradients of one step, given its
        draws. -> (loss, metrics, {name: grad})."""
        pose = RigidTransform(draws["pose"]).compose(make_translation(center))
        density = transform_hu_to_density(projectors[0].volume.data, draws["contrast"])
        # pack/permute once per step, for both renders and the backward
        packed = [p.pack_for_pallas(density) if p.renderer == "trilinear_pallas" else None
                  for p in projectors]
        prepared = [p.prepare_for_shearwarp(density) if p.renderer.endswith(_FAST) else None
                    for p in projectors]
        with torch.no_grad():
            raw = self.render_batch(projectors, pose, density, packed, prepared)
            fg = (raw > 0).to(raw.dtype)
            img = raw.sum(dim=1, keepdim=True)
            if raw.shape[1] > 1:
                hit = (raw[:, 1:].sum(dim=1, keepdim=True) > 0).to(raw.dtype)
                keep = hit.mean(dim=(1, 2, 3)) > MASK_THRESHOLD
            else:
                keep = fg.mean(dim=(1, 2, 3)) > IMG_THRESHOLD
            keep = keep.to(img.dtype)
            x = self.transforms(apply_augmentations(img, draws["aug"]))
        rot, xyz = self.apply_model(x)
        pred_pose = self.model.decode(rot, xyz)
        if self.reframe is not None:
            pred_pose = pred_pose.compose(self.reframe)
        # the re-render at the predicted poses, each in its target's stratum
        praw = self.render_batch(projectors, pred_pose, density, packed, prepared)
        pfg = (praw > 0).to(praw.dtype).detach()
        pimg = praw.sum(dim=1, keepdim=True)
        loss, metrics = pose_regression_loss(
            self.transforms(img), fg, pose, self.transforms(pimg), pfg, pred_pose,
            keep, self.sdd, **self.loss_weights,
        )
        grads = torch.autograd.grad(loss, list(self.params.values()))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, dict(zip(self.params, grads))

    def train_step(self, projectors, center, draws: dict) -> dict:
        """One step on given draws: gradients, then the optimizer."""
        loss, metrics, grads = self.loss_and_grads(projectors, center, draws)
        self.tx.step(self.params, grads, self.opt_state)
        metrics["loss"] = loss
        return metrics

    def _pick_subject(self) -> int:
        if len(self.projectors) == 1:
            return 0
        w = np.ones(len(self.projectors)) if self.subject_weights is None else self.subject_weights
        w = np.asarray(w, dtype=np.float64)
        return int(self.rng.choice(len(self.projectors), p=w / w.sum()))

    def _crop_patch(self, projectors: tuple):
        """A random fixed-size crop of the subject volume, its affine shifted
        so that world geometry is kept; the same crop for every stratum."""
        ph, pw, pd = self.patch_size
        vol = projectors[0].volume
        nx, ny, nz = vol.shape
        ox = int(self.rng.integers(0, max(nx - ph, 0) + 1))
        oy = int(self.rng.integers(0, max(ny - pw, 0) + 1))
        oz = int(self.rng.integers(0, max(nz - pd, 0) + 1))
        sl = (slice(ox, ox + min(ph, nx)), slice(oy, oy + min(pw, ny)), slice(oz, oz + min(pd, nz)))
        data = vol.data[sl]
        mask = vol.mask[sl] if vol.mask is not None else None
        affine = vol.affine.clone()
        offset = torch.tensor([ox, oy, oz], dtype=affine.dtype, device=affine.device)
        affine[:3, 3] += vol.affine[:3, :3] @ offset
        cropped = Volume(data=data, affine=affine, mask=mask, orientation=vol.orientation)
        return tuple(p.replace(volume=cropped, density=data) for p in projectors), cropped.center

    def step(self, itr: int) -> dict:
        idx = self._pick_subject()
        projectors, center = self.projectors[idx], self.centers[idx]
        if self.patch_size is not None:
            projectors, center = self._crop_patch(projectors)
        return self.train_step(projectors, center, self.draw())

    def train(self, run=None, log_every: int = 1, progress: bool = True):
        """Host training loop with checkpointing and logging; under
        ``XVR_PROFILE_DIR`` steps 10-15 are traced."""
        from ..utils.profiling import maybe_trace_dir, start_trace, stop_trace

        t0 = time.time()
        last = {}
        profile_dir = maybe_trace_dir()
        prof = None
        for itr in range(self.start_itr, self.n_total_itrs):
            if itr % self.n_save_every_itrs == 0:
                self._checkpoint(itr)
            if profile_dir and itr == self.start_itr + 10 and prof is None:
                prof = start_trace(profile_dir)
            if prof is not None and itr == self.start_itr + 15:
                stop_trace(prof)
                prof = None
            metrics = self.step(itr)
            if run is not None and itr % 250 == 0:
                try:
                    self._log_figures(itr, run)
                except Exception as e:  # figure logging must never end a run
                    print(f"figure logging failed at itr {itr}: {e}", flush=True)
            if itr % log_every == 0:
                last = {k: float(v) for k, v in metrics.items()}
                last["itr"] = itr
                last["lr"] = float(self.schedule(itr // self.n_grad_accum_itrs))
                last["elapsed"] = time.time() - t0
                self._log(last, run)
                if progress and itr % 50 == 0:
                    msg = " ".join(f"{k}={v:.4f}" for k, v in last.items()
                                   if k not in ("itr", "elapsed"))
                    print(f"[{itr}/{self.n_total_itrs}] {msg}", flush=True)
        if prof is not None:
            stop_trace(prof)
        self._checkpoint(self.n_total_itrs)
        return last

    # ------------------------------------------------------------------
    def _log(self, metrics: dict, run=None):
        with open(self._logfile, "a") as f:
            f.write(json.dumps(metrics) + "\n")
        if run is not None:
            run.log(metrics)

    def figure_images(self, pose: RigidTransform) -> torch.Tensor:
        """The figures' DRRs: the first subject rendered with the golden
        trilinear renderer at ``pose`` (about the isocentre), then at the
        CNN's predicted poses from those renders -> (2n, 1, H, W)."""
        proj = self.projectors[0][0].replace(renderer="trilinear")
        pose = pose.compose(make_translation(self.centers[0]))
        with torch.no_grad():
            img = proj(pose).sum(dim=1, keepdim=True)
            rot, xyz = self.model(self.transforms(img))
            pred_pose = self.model.decode(rot, xyz)
            if self.reframe is not None:
                pred_pose = pred_pose.compose(self.reframe)
            pred = proj(pred_pose).sum(dim=1, keepdim=True)
        return torch.cat([img, pred])

    def _log_figures(self, itr: int, run, n: int = 4):
        """Log a 2 x n grid of target and predicted DRRs at n random poses of
        the first stratum, drawn from the trainer's generator."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from ..visualization.viz2d import plot_drr

        pose = get_random_pose(self.generator, batch_size=n, device=self.device,
                               **self.strata_ranges[0])
        imgs = self.figure_images(pose).cpu().numpy()
        fig, axs = plt.subplots(ncols=n, nrows=2, figsize=(2 * n, 4))
        plot_drr(imgs, axs=axs.flatten(), ticks=False)
        plt.tight_layout()
        run.log({"itr": itr, "imgs": fig})
        plt.close(fig)

    def _checkpoint(self, itr: int):
        path = self.outpath / f"{self.model_number:04d}.ckpt"
        opt_state = self.tx.state_dict(self.opt_state, partial(to_flax_params, self.model))
        save_checkpoint(path, to_flax_params(self.model), opt_state, itr, self.model_number,
                        self.config)
        print(f"Saving checkpoint: {path}", flush=True)
        self.model_number += 1
