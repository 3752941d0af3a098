"""Driver of the ``register_biplane`` traffic kind: a closed loop of one
client that registers one subject's biplane pair per request, a frontal and
a lateral X-ray, with ``xvr_tpu_torch``'s registrar.

Set-up makes the subject from the mix's ``subject_seed`` on the card (the
unmasked vessel volume of :mod:`portbench.scene_biplane`, a pool of frontal
and lateral X-rays of it rendered by the plain reference at the full
detector), writes it where the registrar reads it
(``$TMPDIR/portbench-biplane``: the volume as uncompressed NIfTI, the X-rays
as DICOM of one detector), builds one registrar with the configuration's
flags (no mask, no labels, no crop) and registers one request with two
iterations per stage, which builds the kernels and warms every shape and
permutation the window renders. ``--seed`` places the fiducials and picks
the warm-up request; the window's requests are the same for every seed.

A request is one frontal and one lateral X-ray of the pool, drawn from the
mix's subject seed, in a drawn order, through
``RegistrarBase.register_files(..., max_batch=2)``: the two share the
detector, so they arrive as one batch, whose views march different volume
axes. Everything else (the initial poses, the window, the checks) is the
``register`` driver's: each X-ray's final pose against its view through the
fiducials' projections (``mpd_max_mm``). One check is this driver's own:
the renders of the stage the registration ended in (the projector its
optimization returned, with the renderer and permutation it chose, at the
fine stage, at the stage's batch of ``restart_seeds`` poses: the final pose
and poses about it within the restarts' jitter, from its own volume
operand) against the reference's, as the difference's norm over the
reference's, the widest (``render_gap``). The similarity the registrar
reported is given beside (``sim_gap``, the gap to the reference's) and not
held to a limit: on a subtracted angiogram most 9 x 9 patches of a render
hold one constant, where the local NCC divides float32 rounding by its
variance floor, so the reported similarity moves by up to a few hundredths
with the last bits of a render (PERF.md, section 2).

The context lists one entry per optimization the program ran: the X-rays
of one march axis with the stages recorded under that axis's permutation,
so that the shared readers count each view at its own permutation.
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import reference as ref
from portbench import reference_biplane as rb
from portbench import scene
from portbench import scene_biplane as sb
from portbench.harness import driver

base = driver("register")


def registrar_class():
    class BiplaneRegistrar(base.bench_registrar_class()):
        """The ``register`` driver's registrar, keeping each X-ray's
        projector as its optimization returned it (``used[path]``, the
        result's third element), for the check."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.used = {}

        def run_batch(self, i2ds, *args, **kwargs):
            out = super().run_batch(i2ds, *args, **kwargs)
            self.used.update((base._key(p), res[2]) for p, res in zip(i2ds, out))
            return out

    return BiplaneRegistrar


class Work(base.Work):
    def __init__(self, config: dict, traffic: dict, seed: int, device="cuda"):
        super().__init__(config, traffic, seed, device)
        self.dir = Path(tempfile.gettempdir()) / "portbench-biplane"

    # ------------------------------------------------------------------
    def subject(self) -> None:
        """The vessel volume, its fiducials and the pool of frontal and
        lateral X-rays, written where the registrar reads them."""
        cfg, tr, dev = self.config, self.traffic, self.device
        if self.dir.exists():
            shutil.rmtree(self.dir)
        (self.dir / "xrays").mkdir(parents=True)
        work = np.random.default_rng(int(tr["subject_seed"]))
        hu, aff, self.fids = sb.build_vessels(cfg["ct"]["size"], int(tr["subject_seed"]), dev,
                                              fiducial_seed=self.seed)
        self.affine = aff
        self.affine_inverse = torch.as_tensor(np.linalg.inv(aff), dtype=torch.float32)
        scene.write_nifti(self.dir / "ct.nii", hu.cpu().numpy(), aff)
        t_ct = time.perf_counter()

        xr = cfg["xray"]
        self.det = ref.Detector(xr["sdd"], xr["size"], xr["size"], xr["spacing"], xr["spacing"])
        rot, xyz = sb.draw_views(work, tr["pool"], tr["views"])
        self.inits = [scene.draw_init(work, rot[i], xyz[i], *tr["init"]) for i in range(tr["pool"])]
        self.gt = scene.poses(rot, xyz, "cpu")
        render = rb.Renderer(hu, aff, dev)
        self.pixels, self.paths = [], []
        for i in range(tr["pool"]):
            pose = self.gt[i : i + 1].to(dev)
            perm = render.permutation(pose)
            with ref.no_tf32():
                px = scene.xray_pixels(render.pack(perm), render.affine_inverse, pose, self.det,
                                       perm)
            path = self.dir / "xrays" / f"{i:03d}.dcm"
            scene.write_dicom(path, px, xr["sdd"], xr["spacing"])
            self.pixels.append(px)
            self.paths.append(path)
        self.hu, self.mask = hu.cpu(), None
        self.phases = dict(xrays_s=time.perf_counter() - t_ct)
        del hu, render
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def system(self) -> None:
        """The registrar on the unmasked volume, warmed up on one request
        of the mix; then the window's requests."""
        cfg, tr, dev = self.config, self.traffic, self.device
        t0 = time.perf_counter()
        reg = registrar_class()(str(self.dir / "ct.nii"), None, "AP", device=str(dev),
                                **cfg["registrar"])
        self.reg = reg
        self.phases["registrar_s"] = time.perf_counter() - t0
        itrs = reg.n_itrs
        reg.n_itrs = [int(tr["warmup_itrs"])] * len(itrs)
        self._serve_one(self._draw(np.random.default_rng([self.seed, 1])), 0, record=False)
        reg.n_itrs = itrs
        self.requests = self._order()

    def _draw(self, rng):
        """One request: a frontal and a lateral X-ray of the pool, each with
        its initial pose, in a drawn order."""
        pool = int(self.traffic["pool"])
        frontal = int(rng.integers(0, pool // 2))
        lateral = int(rng.integers(pool // 2, pool))
        order = [frontal, lateral] if rng.integers(0, 2) == 0 else [lateral, frontal]
        return [(i, self.inits[i]) for i in order]

    # ------------------------------------------------------------------
    def reference_similarity(self, items, precision: str = "float32") -> list:
        """The reference's similarity at the fine stage for each (pool index,
        pose (4, 4)) of ``items``: the unmasked volume's render at the pose,
        in the X-ray's own permutation, against the X-ray as the registrar
        preprocesses it, the render's arithmetic in ``precision``."""
        rc = self.config["registrar"]
        fine = rb.fine_detector(self.det, rc["scales"].split(","))
        render = self._reference()
        return [rb.similarity(render, pose, self.pixels[i], fine, bool(rc["linearize"]), precision)
                for i, pose in items]

    def _serve_one(self, request, r: int, record: bool = True):
        super()._serve_one(request, r, record)
        if record:
            self.records[-1]["projectors"] = [self.reg.used[base._key(self.paths[i])]
                                              for i, _ in request]

    def check(self):
        t0 = time.perf_counter()
        checks, info = super().check()
        info["sim_gap_max"] = checks.pop("sim_gap")["value"]  # reported, not checked
        projectors = [p for rec in self.records for p in rec["projectors"]]
        with ref.no_tf32():
            gaps = [self.render_gap(final, proj)
                    for (_, _, final, _), proj in zip(self._answers(), projectors)]
        checks["render_gap"] = dict(value=max(gaps, default=float("nan")),
                                    limit=self.config["correct"]["render_gap"])
        info.update(render_gap=gaps, renderers=sorted({p.renderer for p in projectors}),
                    check_s=time.perf_counter() - t0)
        return checks, info

    def stage_poses(self, pose) -> torch.Tensor:
        """(S, 4, 4) on the device: ``pose`` (4, 4) and S - 1 poses about it,
        each moved by up to the restarts' jitter (degrees per ZXY angle, mm
        per camera axis), S the registrar's ``restart_seeds``: a batch of
        the shape the stage renders, drawn from ``--seed``."""
        rc = self.config["registrar"]
        S = int(rc["restart_seeds"])
        rng = np.random.default_rng([self.seed, 3])
        rot = np.deg2rad(rng.uniform(-1, 1, (S - 1, 3)) * float(rc["restart_jitter_rot"]))
        xyz = rng.uniform(-1, 1, (S - 1, 3)) * float(rc["restart_jitter_xyz"])
        move = ref.pose_zxy(torch.as_tensor(rot), torch.as_tensor(xyz))
        M = torch.as_tensor(np.asarray(pose, np.float64).reshape(1, 4, 4))
        return torch.cat([M, M @ move]).to(torch.float32).to(self.device)

    def _reference(self):
        if getattr(self, "_renderer", None) is None:
            self._renderer = rb.Renderer(self.hu, self.affine, self.device)
        return self._renderer

    def render_gap(self, pose, proj=None, precision: str = "float32") -> float:
        """The fine stage's renders at :meth:`stage_poses` about ``pose``
        (4, 4): ``proj``'s (the projector a registration returned, at the
        fine stage, from its own volume operand) or, without one, the
        reference's in ``precision``, against the float32 reference's, as
        the difference's norm over the reference's; the widest of the
        batch."""
        rc = self.config["registrar"]
        fine = rb.fine_detector(self.det, rc["scales"].split(","))
        render = self._reference()
        poses = self.stage_poses(pose)
        want = torch.cat([render(p[None], fine) for p in poses]).double()
        if proj is None:
            got = torch.cat([render(p[None], fine, precision) for p in poses]).double()
        else:
            from xvr_tpu_torch.geometry import RigidTransform

            fp = proj.rescale_detector(float(rc["scales"].split(",")[-1]))
            with torch.no_grad():
                got = fp(RigidTransform(poses), prepared=fp.prepare())[:, 0].double()
        gaps = torch.linalg.norm(got - want, dim=(1, 2)) / torch.linalg.norm(want, dim=(1, 2))
        return float(gaps.max())

    def _optimizations(self, rec) -> list:
        """A request's optimizations as the program ran them: its X-rays
        grouped by the march axis of each one's initial pose, in the order of
        their first X-ray, each with the run of stages recorded under one
        permutation."""
        axes = {}
        for i, (rot, xyz) in rec["request"]:
            pose = scene.poses(rot, xyz, "cpu")
            axes.setdefault(ref.permutation(pose, np.linalg.inv(self.affine))[0], []).append(i)
        runs = []
        for st in rec["stages"]:
            if not runs or st.get("perm") != runs[-1][0].get("perm"):
                runs.append([])
            runs[-1].append(st)
        if len(runs) != len(axes):
            raise ValueError(f"{len(runs)} runs of stages under one permutation in a request "
                             f"whose X-rays march {len(axes)} axes")
        return list(zip(axes.values(), runs))

    def context(self) -> dict:
        rc = self.config["registrar"]
        reqs = [dict(gt=np.stack([self.gt[i].numpy() for i in xrays]), stages=stages)
                for rec in self.records for xrays, stages in self._optimizations(rec)]
        return dict(requests=reqs, client_requests=len(self.records),
                    vol_shape=tuple(self.hu.shape), affine_inverse=self.affine_inverse,
                    stage_dets=ref.stage_detectors(self.det, rc["scales"].split(","), 0),
                    restart_seeds=int(rc["restart_seeds"]))
