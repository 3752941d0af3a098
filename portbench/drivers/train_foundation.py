"""Driver of the ``train_foundation`` traffic kind: a closed loop of
``xvr_tpu_torch``'s training step, ``Trainer.step``, over a directory of CTs
(xvr's patient-agnostic "foundation" pretraining).

Set-up makes the configuration's subjects from the seed on the card, each a
DeepFluoro-like phantom (``scene.build_ct`` from ``--seed`` plus the
subject's ``seed_offset``, and ``scene.deepfluoro_mask``) cut to its depth
about the centre along the slice axis, its affine moved so that world
geometry is kept, and writes them where the trainer reads them: one
directory of CTs and one of labelmaps under ``$TMPDIR/portbench-subject``
(uncompressed NIfTI, the same file name for a CT and its labelmap). It
builds one ``Trainer`` on the two directories, with the configuration's
flags and a seed drawn from ``--seed``, loads the weights the benchmark made
from the seed, and takes the mix's first steps (``checked_steps``) through
``Trainer.step``, the window's own call. The route must be shear-warp for
every subject with one permutation, or set-up fails. While the checked steps
run, each step's subject (``Trainer._pick_subject``), its target renders
(``Trainer.render_batch``'s first call) and the first step's CNN outputs
(``Trainer.apply_model``) are recorded; after the step that applies the
first update, the mean gradient as Adam holds it (its first moment over
1 - b1). The window then goes on with the same object and the same call,
and closes at the end of the first step that ends after ``--seconds``.

After the window the reference (``portbench/reference_foundation.py``)
takes the same first steps from the same weights, on the same draws
(``reference_train.draw`` from a generator seeded as the trainer's) and the
same subjects (``reference_foundation.picks``, a frozen copy of the
trainer's pick). Compared: the subjects (``subject_gap``, the number of
steps whose subject differs); the target renders of every checked step,
channel by channel (``render_gap``: :func:`render_gaps`, the worst
channel of the checked steps); the first
step's CNN outputs (``cnn1_gap``) and loss (``loss1_gap``), as the finetune
cell's; the mean gradient at the first update (``grad_gap``: the norm of
the difference over the reference's norm, over the leaves compared
together; each leaf's, over the larger of its norm and the median leaf's,
is reported); and the parameters' change over the
checked steps (``step_gap``, as the finetune cell's: the gap between the
norms, worst leaf). Leaves whose reference gradient is under a thousandth
of the median leaf's are left out of the last two, which are read only
where an update falls within the checked steps.

The controls (``control``) put the reference in the program's place with
one thing changed: its renders in bfloat16 (``bf16``); its subjects picked
from another seed (``pick``), so that another subject is rendered; its
accumulation skipped, one update a step (``every_k_1``).
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import harness
from portbench import reference as ref
from portbench import reference_foundation as rf
from portbench import reference_train as rt
from portbench import scene

_train = harness.load_file("portbench_driver_train", Path(__file__).resolve().parent / "train.py")
make_weights, TERMS = _train.make_weights, _train.TERMS


def render_gaps(a: torch.Tensor, b: torch.Tensor) -> list:
    """Per channel of (B, C, H, W) renders: the norm of ``a - b`` over the
    larger of ``b``'s norm and the mean channel's. (The finetune cell's
    measure takes the median channel's, which is rounding residue when
    half the channels are empty: the background, the whole density less
    the labels, is near zero where the labels cover every tissue, and
    labels out of view render zero.)"""
    a, b = a.double(), b.double()
    diff = torch.linalg.norm((a - b).transpose(0, 1).reshape(a.shape[1], -1), dim=1)
    size = torch.linalg.norm(b.transpose(0, 1).reshape(b.shape[1], -1), dim=1)
    scale = torch.clamp(size, min=float(size.mean())).clamp_min(1e-30)
    return (diff / scale).tolist()


def cut(hu: torch.Tensor, mask: torch.Tensor, affine: np.ndarray, depth: int):
    """``depth`` slices about the centre of the slice (third) axis, the
    affine moved so that each kept voxel keeps its world position."""
    z0 = (hu.shape[2] - depth) // 2
    aff = affine.copy()
    aff[:3, 3] += aff[:3, :3] @ np.array([0.0, 0.0, z0])
    return hu[:, :, z0:z0 + depth].contiguous(), mask[:, :, z0:z0 + depth].contiguous(), aff


class Work:
    def __init__(self, config: dict, traffic: dict, seed: int, device="cuda"):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.dir = Path(tempfile.gettempdir()) / "portbench-subject"
        self.trainer_seed = (self.seed + 1) % 2**31  # the trainer's draws and picks
        self.steps = self.window_steps = 0

    def _draws(self) -> list:
        """The checked steps' draws, made again as ``Trainer.draw`` makes
        them from the trainer's seed."""
        t = self.config["trainer"]
        gen = torch.Generator(device=self.device).manual_seed(self.trainer_seed)
        return [rt.draw(gen, self.ranges, int(t["batch_size"]), int(t["height"]),
                        float(t["p_augmentation"]))
                for _ in range(int(self.traffic["checked_steps"]))]

    def setup(self) -> None:
        t0 = time.perf_counter()
        self.subject()
        t1 = time.perf_counter()
        self.system()
        self.phases = dict(subjects_s=t1 - t0, **self.phases)

    def subject(self) -> None:
        """The subjects' CTs and labelmaps, written where the trainer reads
        them, and the weights, all from the seed."""
        cfg, dev = self.config, self.device
        if self.dir.exists():
            shutil.rmtree(self.dir)
        vols, masks = self.dir / "volumes", self.dir / "masks"
        vols.mkdir(parents=True)
        masks.mkdir()
        self.subjects = []
        for s in cfg["subjects"]:
            hu, aff, _ = scene.build_ct(cfg["ct"]["size"], self.seed + int(s["seed_offset"]), dev)
            hu, mask, aff = cut(hu, scene.deepfluoro_mask(hu), aff, int(s["depth"]))
            scene.write_nifti(vols / s["file"], hu.cpu().numpy(), aff)
            scene.write_nifti(masks / s["file"], mask.cpu().numpy(), aff)
            self.subjects.append((hu.cpu(), mask.cpu(), aff))
            del hu, mask
        self.shapes = [tuple(hu.shape) for hu, _, _ in self.subjects]
        self.padded = tuple(int(n) for n in np.max(self.shapes, axis=0))
        t = cfg["trainer"]
        self.ranges = {k: float(v) for k, v in t["ranges"].items()}
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        self.weights = make_weights(gen, rt.resnet34_layout(), self.ranges, cfg["head_std"],
                                    float(t["unit_conversion_factor"]), dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def system(self) -> None:
        """The system under test on the two directories with the
        benchmark's weights, taken through the checked steps by the window's
        own call, which also build and warm everything; the steps' subjects,
        target renders, the first CNN outputs and the first update's mean
        gradient are recorded on the way."""
        from xvr_tpu_torch.train.trainer import Trainer

        t, dev = self.config["trainer"], self.device
        t1 = time.perf_counter()
        trainer = Trainer(str(self.dir / "volumes"), str(self.dir / "masks"),
                          str(self.dir / "train_out"), **self.ranges,
                          **{k: v for k, v in t.items() if k != "ranges"},
                          seed=self.trainer_seed, device=str(dev))
        have = {k: tuple(v.shape) for k, v in trainer.model.named_parameters()}
        if have != rt.resnet34_layout():
            raise RuntimeError("the trainer's model is not the ResNet-34 pose regressor the "
                               "benchmark makes weights for")
        projs = [p for tup in trainer.projectors for p in tup]
        self.perms = sorted({p.pallas_perm for p in projs}, key=str)
        self.renderers = sorted({p.renderer for p in projs})
        if (len(trainer.projectors) != len(self.subjects) or len(self.perms) != 1
                or not all(r.endswith("_fast") for r in self.renderers)):
            raise RuntimeError(f"the route is not shear-warp with one permutation for every "
                               f"subject: renderers {self.renderers}, permutations {self.perms}, "
                               f"{len(trainer.projectors)} subjects of {len(self.subjects)}")
        trainer.model.load_state_dict(self.weights)
        self.trainer = trainer
        self.route = trainer.route()
        self.conv_tf32 = bool(torch.backends.cudnn.allow_tf32)
        t2 = time.perf_counter()
        self.picks, self.losses, self.terms, self.renders, calls = [], [], [], [], []
        pick, render_batch, apply_model = (trainer._pick_subject, trainer.render_batch,
                                           trainer.apply_model)

        def record(fn):
            def wrapped(*a, **kw):
                out = fn(*a, **kw)
                calls.append((fn, out))
                return out
            return wrapped

        trainer._pick_subject, trainer.render_batch, trainer.apply_model = (
            record(pick), record(render_batch), record(apply_model))
        self.g1 = None
        try:
            for k in range(int(self.traffic["checked_steps"])):
                calls.clear()
                m = trainer.step(self.steps)
                self.steps += 1
                self.picks.append(next(o for f, o in calls if f == pick))
                self.losses.append(float(m["loss"]))
                self.terms.append({term: float(m[term]) for term in TERMS})
                self.renders.append(next(o for f, o in calls if f == render_batch).detach().cpu())
                if k == 0:
                    self.cnn1 = tuple(v.detach().cpu() for v in
                                      next(o for f, o in calls if f == apply_model))
                if k == int(t["n_grad_accum_itrs"]) - 1:
                    self.g1 = {n: (v / (1 - rt.B1)).clone()
                               for n, v in trainer.opt_state["mu"].items()}
        finally:
            del trainer._pick_subject, trainer.render_batch, trainer.apply_model
        self.p_end = {n: v.detach().clone() for n, v in trainer.params.items()}
        self.phases = dict(trainer_s=t2 - t1, checked_steps_s=time.perf_counter() - t2)

    def serve(self, t0: float, seconds: float, trace: bool) -> dict:
        tr, trainer = self.traffic, self.trainer
        B = int(self.config["trainer"]["batch_size"])
        limit = int(tr["traced_requests"]) if trace else 10**9
        checked = self.steps
        while self.steps - checked < limit:
            trainer.step(self.steps)
            self.steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = self.steps - checked
        self.window_steps = n
        return dict(attempted=n * B, failed=0, e2e=dict(train_images_per_s=n * B / wall))

    def check(self):
        self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        run = dict(picks=self.picks, losses=self.losses, terms=self.terms, g1=self.g1,
                   p_end=self.p_end, renders=self.renders, cnn1=self.cnn1)
        checks, info = self.compare(run, self.reference_run())
        return checks, dict(setup_phases=self.phases, route=str(self.route),
                            permutations=str(self.perms), subject_shapes=str(self.shapes), **info)

    def reference_run(self, precision: str = "float32", every_k: int | None = None,
                      pick_seed: int | None = None, renders_only: bool = False) -> dict:
        """The reference through the checked steps from the same weights on
        the same draws and, unless ``pick_seed`` says otherwise, the same
        subjects. ``renders_only``: the target renders alone."""
        dev = self.device
        n = int(self.traffic["checked_steps"])
        with ref.no_tf32():
            f = rf.Foundation([(hu.to(dev), mask.to(dev), aff) for hu, mask, aff in self.subjects],
                              self.config, self.weights, precision, every_k)
            picks = rf.picks(self.trainer_seed if pick_seed is None else pick_seed,
                             len(self.subjects), n)
            losses, terms, renders = [], [], []
            for d, s in zip(self._draws(), picks):
                if renders_only:
                    renders.append(rf.targets(f.steps[s], d)[3].cpu())
                    continue
                m = f(d, s)
                losses.append(m["loss"])
                terms.append({term: m[term] for term in TERMS})
                renders.append(f.raw.cpu())
        if renders_only:
            return dict(picks=picks, renders=renders)
        return dict(picks=picks, losses=losses, terms=terms, g1=f.first_update, p_end=f.params,
                    renders=renders, cnn1=tuple(v.cpu() for v in f.cnn_out))

    def control(self, kind: str) -> dict:
        """The reference in the program's place with one thing changed,
        compared with the float32 reference as a run is. -> the values."""
        if kind == "bf16":
            run = self.reference_run("bfloat16", renders_only=True)
        elif kind == "pick":
            run = self.reference_run(pick_seed=self.trainer_seed + 1, renders_only=True)
        elif kind == "every_k_1":
            run = self.reference_run(every_k=1)
        else:
            raise ValueError(f"no control {kind!r}")
        reference = self.reference_run(renders_only=run.keys() == {"picks", "renders"})
        return self.compare(run, reference)[1]

    def compare(self, run: dict, reference: dict):
        """``run`` against ``reference``, each a dict of the steps'
        ``picks`` and target ``renders`` and, where both have them, the
        ``losses``, ``terms`` and first CNN outputs ``cnn1``, and, where an
        update fell within the checked steps, its mean gradient ``g1`` and
        the parameters after the steps ``p_end``. -> (checks, info)."""
        values = dict(
            subject_gap=sum(a != b for a, b in zip(run["picks"], reference["picks"])),
            render_gap=max(max(render_gaps(a, b)) for a, b in zip(run["renders"],
                                                                   reference["renders"])))
        info = dict(picks=run["picks"], picks_reference=reference["picks"])
        if "losses" in run and "losses" in reference:
            rel = [abs(a - b) / max(abs(b), 1e-12)
                   for a, b in zip(run["losses"], reference["losses"])]
            c_gaps = [float(torch.linalg.norm(a.double() - b.double())
                            / torch.linalg.norm(b.double() - b.double().mean(dim=0))
                            .clamp_min(1e-30))
                      for a, b in zip(run["cnn1"], reference["cnn1"])]
            values.update(loss1_gap=rel[0], cnn1_gap=max(c_gaps),
                          mncc1_gap=abs(run["terms"][0]["mncc"] - reference["terms"][0]["mncc"]))
            info.update(loss=run["losses"], loss_reference=reference["losses"], loss_gaps=rel,
                        cnn1_gaps=dict(zip(("rot", "xyz"), c_gaps)))
        if run.get("g1") is not None and reference.get("g1") is not None:
            values_, info_ = self._compare_update(run, reference)
            values.update(values_)
            info.update(info_)
        lim = self.config["correct"]
        checks = {k: dict(value=values[k], limit=lim[k]) for k in lim if k in values}
        return checks, dict(values, **info)

    def _compare_update(self, run: dict, reference: dict):
        """The first update's mean gradient and the parameters' change."""
        gn = {n: float(torch.linalg.norm(v)) for n, v in reference["g1"].items()}
        med_g = float(np.median(list(gn.values())))
        leaves = [n for n in gn if gn[n] >= 1e-3 * med_g]

        def worst(g: dict):
            n = max(g, key=g.get)
            return n, g[n]

        g_diff = {n: float(torch.linalg.norm(run["g1"][n].float() - reference["g1"][n].float()))
                  for n in leaves}
        g_gap = {n: g_diff[n] / max(gn[n], med_g, 1e-30) for n in leaves}
        g_all = (sum(d * d for d in g_diff.values()) / sum(gn[n] ** 2 for n in leaves)) ** 0.5
        d_run = {n: float(torch.linalg.norm((run["p_end"][n] - self.weights[n]).float()))
                 for n in leaves}
        d_ref = {n: float(torch.linalg.norm((reference["p_end"][n] - self.weights[n]).float()))
                 for n in leaves}
        med_d = float(np.median(list(d_ref.values())))
        s_gap = {n: abs(d_run[n] - d_ref[n]) / max(d_ref[n], med_d, 1e-30) for n in leaves}
        values = dict(grad_gap=g_all, step_gap=worst(s_gap)[1])
        info = dict(leaves_compared=f"{len(leaves)} of {len(gn)}",
                    grad_worst_leaf=f"{worst(g_gap)[0]}: gap {worst(g_gap)[1]:.3g}",
                    grad_gap_worst_leaf=worst(g_gap)[1],
                    grad_gap_median=float(np.median(list(g_gap.values()))),
                    step_worst_leaf=f"{worst(s_gap)[0]}: gap {worst(s_gap)[1]:.3g}",
                    step_gap_median=float(np.median(list(s_gap.values()))))
        return values, info

    def window_picks(self) -> list:
        """The window's subjects, by the trainer's pick from its seed (the
        checked steps' picks are compared with it)."""
        checked = int(self.traffic["checked_steps"])
        return rf.picks(self.trainer_seed, len(self.subjects),
                        checked + self.window_steps)[checked:]

    def context(self) -> dict:
        t = self.config["trainer"]
        return dict(steps=self.window_steps, batch=int(t["batch_size"]), height=int(t["height"]),
                    first_pose=self._draws()[0]["pose"].cpu(), ranges=self.ranges,
                    route=self.route, trainer_cfg=t, conv_tf32=self.conv_tf32,
                    subject_shapes=self.shapes, padded_shape=self.padded,
                    affines=[aff for _, _, aff in self.subjects],
                    masks=[mask for _, mask, _ in self.subjects],
                    window_picks=self.window_picks())
