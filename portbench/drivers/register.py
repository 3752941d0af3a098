"""Driver of the ``register`` traffic kind: a closed loop of one client that
registers X-rays of one subject with ``xvr_tpu_torch``'s registrar.

Set-up makes the subject from the seed on the card (the CT with its
DeepFluoro labelmap and fiducials, a pool of X-rays of the whole CT rendered
by the plain reference at ground-truth views about the two DeepFluoro views),
writes it where the registrar reads it (``$TMPDIR/portbench-subject``: the CT
and the mask as uncompressed NIfTI, the X-rays as DICOM), builds one
registrar with the configuration's flags and registers one request with two
iterations per stage, which builds the kernels and warms every shape the
window renders.

The work is fixed by the mix's ``subject_seed``: the CT's texture, the
pool's views, each X-ray's initial pose (its view moved by the mix's
``init`` draw) and the order of the requests (the pool walked in
permutations drawn from it). ``--seed`` places the fiducials and picks the
warm-up request, so every seed serves the same requests in the same order.
The mix's ``batch`` sets the request: with 1, ``RegistrarBase.run`` on one
X-ray; with more, ``RegistrarBase.register_files`` on that many X-rays of
the pool at once (``max_batch`` = ``batch``), which batches them into one
optimization. The registrar reads each initial pose through
:class:`BenchRegistrar`, whose only difference from ``RegistrarFixed`` is that
the pose comes per file. The window closes at the end of the first request
that ends after ``--seconds``.

After the window every X-ray registered in it is checked: its final pose
against its view through the fiducials, as the mean distance of their
projections on the detector (``mpd_max_mm``, the worst X-ray of the window;
the 3D mTRE is reported beside it), and the similarity the registrar
reported at that pose against the reference's (``sim_gap``, the widest
gap).
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from portbench import reference as ref
from portbench import scene


def _key(path) -> str:
    return str(Path(path).resolve())


def bench_registrar_class():
    from xvr_tpu_torch.geometry import RigidTransform
    from xvr_tpu_torch.io.xray import read_xray
    from xvr_tpu_torch.registrar.base import RegistrarBase

    class BenchRegistrar(RegistrarBase):
        """``RegistrarFixed`` with the initial pose given per X-ray file
        (``inits[path]``, a (1, 4, 4) matrix)."""

        def __init__(self, volume, mask, orientation, **kwargs):
            super().__init__(volume, mask, orientation, save_kwargs={"type": "fixed"}, **kwargs)
            self.inits = {}

        def initialize_pose(self, i2d):
            xray = read_xray(i2d, self.crop, self.subtract_background, self.linearize,
                             self.reducefn)
            return (*xray, RigidTransform(self.inits[_key(i2d)].to(self.device)))

    return BenchRegistrar


class Work:
    def __init__(self, config: dict, traffic: dict, seed: int, device="cuda"):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.dir = Path(tempfile.gettempdir()) / "portbench-subject"
        self.records = []

    # ------------------------------------------------------------------
    def setup(self) -> None:
        t0 = time.perf_counter()
        self.subject()
        t1 = time.perf_counter()
        self.system()
        self.phases = dict(subject_s=t1 - t0, system_s=time.perf_counter() - t1,
                           **getattr(self, "phases", {}))

    def subject(self) -> None:
        """The CT, its labelmap and fiducials, and the pool of X-rays, from
        the seed; written where the registrar reads them."""
        cfg, tr, dev = self.config, self.traffic, self.device
        if self.dir.exists():
            shutil.rmtree(self.dir)
        (self.dir / "xrays").mkdir(parents=True)
        ct = cfg["ct"]
        # the work is the mix's own: the CT's texture, the views and their
        # initial poses come from its subject seed; --seed orders the
        # requests and places the fiducials
        work = np.random.default_rng(int(tr["subject_seed"]))
        hu, aff, self.fids = scene.build_ct(ct["size"], int(tr["subject_seed"]), dev,
                                            fiducial_seed=self.seed)
        mask = scene.deepfluoro_mask(hu)
        self.affine = aff
        self.affine_inverse = torch.as_tensor(np.linalg.inv(aff), dtype=torch.float32)
        scene.write_nifti(self.dir / "ct.nii", hu.cpu().numpy(), aff)
        scene.write_nifti(self.dir / "mask.nii", mask.cpu().numpy(), aff)
        t_ct = time.perf_counter()

        # the pool: X-rays of the whole CT at views about the DeepFluoro views
        xr = cfg["xray"]
        self.det = ref.Detector(xr["sdd"], xr["size"], xr["size"], xr["spacing"], xr["spacing"])
        rot, xyz = scene.draw_views(work, tr["pool"], *tr["views"])
        self.inits = [scene.draw_init(work, rot[i], xyz[i], *tr["init"]) for i in range(tr["pool"])]
        self.gt = scene.poses(rot, xyz, "cpu")
        density = ref.hu_to_density(hu)
        Ainv = self.affine_inverse.to(dev)
        self.pixels, self.paths, packed = [], [], {}
        for i in range(tr["pool"]):
            pose = self.gt[i : i + 1].to(dev)
            perm = ref.permutation(pose, np.linalg.inv(aff))
            if perm not in packed:
                packed[perm] = density.permute(*perm).contiguous().to(torch.bfloat16)
            with ref.no_tf32():
                px = scene.xray_pixels(packed[perm], Ainv, pose, self.det, perm)
            path = self.dir / "xrays" / f"{i:03d}.dcm"
            scene.write_dicom(path, px, xr["sdd"], xr["spacing"])
            self.pixels.append(px)
            self.paths.append(path)
        self.hu, self.mask = hu.cpu(), mask.cpu()
        self.phases = dict(xrays_s=time.perf_counter() - t_ct)
        del hu, mask, density, packed, Ainv
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def system(self) -> None:
        """The system under test, warmed up on one request of the mix; then
        the window's requests."""
        cfg, tr, dev = self.config, self.traffic, self.device
        t0 = time.perf_counter()
        reg = bench_registrar_class()(str(self.dir / "ct.nii"), str(self.dir / "mask.nii"), "AP",
                                      device=str(dev), **cfg["registrar"])
        self.reg = reg
        self.phases["registrar_s"] = time.perf_counter() - t0
        itrs = reg.n_itrs
        reg.n_itrs = [int(tr["warmup_itrs"])] * len(itrs)
        warm = np.random.default_rng([self.seed, 1])
        self._serve_one(self._draw(warm), 0, record=False)
        reg.n_itrs = itrs
        self._cycle = None
        self.requests = self._order()

    def _order(self):
        """The window's requests, the same for every seed: the pool walked
        in orders drawn from the mix's subject seed, each X-ray with its
        own initial pose."""
        tr = self.traffic
        rng = np.random.default_rng([int(tr["subject_seed"]), 2])
        return [self._draw(rng) for _ in range(int(tr["max_requests"]))]

    def _draw(self, rng):
        """One request: ``batch`` X-rays of the pool, each with its initial
        pose, in an order drawn from ``rng``; one X-ray at a time walks the
        pool in permutations drawn from it."""
        tr = self.traffic
        pool, batch = int(tr["pool"]), int(tr["batch"])
        if batch > 1:
            order = rng.permutation(pool)[:batch]
        else:
            if not getattr(self, "_cycle", None):
                self._cycle = rng.permutation(pool).tolist()
            order = [self._cycle.pop()]
        return [(int(i), self.inits[i]) for i in order]

    def _serve_one(self, request, r: int, record: bool = True):
        reg = self.reg
        for i, (rot, xyz) in request:
            reg.inits[_key(self.paths[i])] = scene.poses(rot, xyz, "cpu")
        mark = len(reg.stage_log)
        if len(request) == 1:
            res = reg.run(str(self.paths[request[0][0]]))
            answers = [(res[4].matrix.detach(), res[5]["trajectory"]["ncc"][-1])]
        else:
            out = self.dir / "out" / f"{r:05d}"
            saved = reg.register_files([self.paths[i] for i, _ in request], out,
                                       max_batch=len(request))
            answers = list(saved)
        if record:
            self.records.append(dict(request=request, answers=answers,
                                     stages=list(reg.stage_log[mark:])))

    # ------------------------------------------------------------------
    def serve(self, t0: float, seconds: float, trace: bool) -> dict:
        tr = self.traffic
        limit = int(tr["traced_requests"]) if trace else len(self.requests)
        attempted = failed = 0
        for r, request in enumerate(self.requests[:limit]):
            attempted += len(request)
            try:
                self._serve_one(request, r)
            except Exception:  # a request that fails counts, and the window goes on
                failed += len(request)
                traceback.print_exc()
            if time.perf_counter() - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = sum(len(rec["request"]) for rec in self.records)
        return dict(attempted=attempted, failed=failed,
                    e2e=dict(register_s=wall / max(n, 1), sweep_xrays_per_min=60.0 * n / wall))

    # ------------------------------------------------------------------
    def _answers(self):
        """(pool index, initial pose, final pose, reported similarity) of
        every X-ray registered in the window."""
        out = []
        for rec in self.records:
            for (i, (rot, xyz)), ans in zip(rec["request"], rec["answers"]):
                if isinstance(ans, tuple):
                    final, sim = ans[0].cpu().numpy().reshape(4, 4), float(ans[1])
                else:
                    with np.load(Path(ans) / "parameters.npz") as z:
                        final = z["final_pose"].reshape(4, 4)
                        sim = float(z["trajectory_ncc"][-1])
                out.append((i, scene.poses(rot, xyz, "cpu").numpy().reshape(4, 4), final, sim))
        return out

    def check(self):
        with ref.no_tf32():
            return self._check()

    def _check(self):
        answers = self._answers()
        sims = self.reference_similarity([(i, final) for i, _, final, _ in answers])
        gaps = [abs(r - sim) for r, (_, _, _, sim) in zip(sims, answers)]
        mtre = [ref.fiducial_mtre(final, self.gt[i].numpy(), self.fids) for i, _, final, _ in answers]
        mtre0 = [ref.fiducial_mtre(init, self.gt[i].numpy(), self.fids) for i, init, _, _ in answers]
        sdd = self.det.sdd
        mpd = [ref.projection_distance(final, self.gt[i].numpy(), self.fids, sdd)
               for i, _, final, _ in answers]
        mpd0 = [ref.projection_distance(init, self.gt[i].numpy(), self.fids, sdd)
                for i, init, _, _ in answers]
        lim = self.config["correct"]
        nan = float("nan")
        checks = {"mpd_max_mm": dict(value=max(mpd, default=nan), limit=lim["mpd_max_mm"]),
                  "sim_gap": dict(value=max(gaps, default=nan), limit=lim["sim_gap"])}
        info = dict(setup_phases=getattr(self, "phases", {}), xrays=len(answers),
                    mtre_median_mm=float(np.median(mtre)) if mtre else nan,
                    mtre_mean_mm=float(np.mean(mtre)) if mtre else nan,
                    mpd_mean_mm=float(np.mean(mpd)) if mpd else nan,
                    mpd_init_min_mm=min(mpd0, default=nan),
                    mtre_mm=mtre, mtre_init_mm=mtre0, mpd_mm=mpd, mpd_init_mm=mpd0, sim_gap=gaps)
        return checks, info

    def reference_similarity(self, items, precision: str = "float32") -> list:
        """The reference's similarity at the fine stage for each (pool index,
        pose (4, 4)) of ``items``: the masked CT's render at the pose against
        the X-ray as the registrar preprocesses it, the render's arithmetic
        in ``precision``."""
        rc, dev = self.config["registrar"], self.device
        crop = int(rc["crop"])
        cropped = ref.Detector(self.det.sdd, self.det.height - crop, self.det.width - crop,
                               self.det.delx, self.det.dely)
        fine = ref.stage_detectors(cropped, rc["scales"].split(","), crop)[-1]
        labels = [int(x) for x in rc["labels"].split(",")]
        density = ref.hu_to_density(ref.kept_hu(self.hu.to(dev), self.mask.to(dev), labels))
        Ainv = self.affine_inverse.to(dev)
        out, packed = [], {}
        for i, pose in items:
            pose = torch.as_tensor(pose, dtype=torch.float32, device=dev).reshape(1, 4, 4)
            perm = ref.permutation(pose, np.linalg.inv(self.affine))
            if perm not in packed:
                packed[perm] = density.permute(*perm).contiguous().to(torch.bfloat16)
            img = ref.render(packed[perm], Ainv, pose, fine, perm, precision)[:, None]
            xray = ref.preprocess_xray(self.pixels[i], crop, bool(rc["linearize"])).to(dev)
            s = ref.similarity(ref.xray_transform(xray, fine.height, fine.width),
                               ref.xray_transform(img, fine.height, fine.width))
            out.append(float(s[0]))
        return out

    def context(self) -> dict:
        rc = self.config["registrar"]
        crop = int(rc["crop"])
        cropped = ref.Detector(self.det.sdd, self.det.height - crop, self.det.width - crop,
                               self.det.delx, self.det.dely)
        reqs = [dict(gt=np.stack([self.gt[i].numpy() for i, _ in rec["request"]]),
                     stages=rec["stages"]) for rec in self.records]
        return dict(requests=reqs, vol_shape=tuple(self.hu.shape),
                    affine_inverse=self.affine_inverse,
                    stage_dets=ref.stage_detectors(cropped, rc["scales"].split(","), crop),
                    restart_seeds=int(rc["restart_seeds"]))
