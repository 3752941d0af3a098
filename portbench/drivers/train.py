"""Driver of the ``train`` traffic kind: a closed loop of ``xvr_tpu_torch``'s
training step, ``Trainer.step``.

Set-up makes the CT with its DeepFluoro labelmap from the seed on the card
and writes them where the trainer reads them (``$TMPDIR/portbench-subject``,
uncompressed NIfTI), builds one ``Trainer`` with the configuration's flags
and a seed drawn from ``--seed``, loads the weights the benchmark made from
the seed into its model, and takes the mix's first steps
(``checked_steps``) through ``Trainer.step``, the window's own call on the
trainer's own draws; those steps build the kernels and warm every shape.
While they run, the target renders (``Trainer.render_batch``'s first call
in each step: the batch with its label channels) and the first step's CNN
outputs (``Trainer.apply_model``) are recorded. The window then goes on
with the same object and the same call, and closes at the end of the first
step that ends after ``--seconds``.

After the window the reference takes the same first steps from the same
weights on the same draws, which it makes again from the trainer's seed
(:func:`portbench.reference_train.draw` draws what ``Trainer.draw`` draws,
in kind and order, from a generator seeded alike). Compared: the target
renders, channel by channel (``render_gap``: the norm of the difference
over the larger of the reference channel's norm and the median channel's,
the worst channel of the checked steps); the first step's CNN outputs
(``cnn1_gap``: the norm of the difference over the norm of the reference's
spread about its batch mean, the larger of the rotation and the
translation heads); the first step's loss (``loss1_gap``, relative; every
step's is reported); and the parameters' change over the checked steps
(``step_gap``, the worst leaf), each leaf by the gap between the program's
norm and the reference's over the larger of the reference's norm of that
leaf and of the median leaf. The first gradient as the optimizer holds it
after one step (Adam's first moment over 1 - b1; ``grad_gap``, the worst
leaf) is reported. Leaves whose reference gradient is under a thousandth of
the median leaf's are left out of both. The configuration's ``correct``
names the numbers compared; the others are reported.
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
from portbench import reference_train as rt
from portbench import scene

TERMS = ("mncc", "dice", "dgeo", "kept")  # the step's metrics held beside its loss


def render_gaps(a: torch.Tensor, b: torch.Tensor) -> list:
    """Per channel of (B, C, H, W) renders: the norm of ``a - b`` over the
    larger of ``b``'s norm and the median channel's."""
    a, b = a.double(), b.double()
    diff = torch.linalg.norm((a - b).transpose(0, 1).reshape(a.shape[1], -1), dim=1)
    size = torch.linalg.norm(b.transpose(0, 1).reshape(b.shape[1], -1), dim=1)
    scale = torch.clamp(size, min=float(size.median())).clamp_min(1e-30)
    return (diff / scale).tolist()


def make_weights(gen: torch.Generator, layout: dict, ranges: dict, head_std: float,
                 unit: float, device) -> dict:
    """Weights of the pose regressor from ``gen`` in one draw: convolution
    kernels normal with variance 1 / fan-in, norms' scales 1 and shifts 0,
    head kernels normal with deviation ``head_std`` and head biases at the
    middle of the sampling ranges (so that the predicted poses spread about
    it and their re-renders view the volume)."""
    kernels = [k for k, s in layout.items() if k.endswith(".weight") and len(s) == 4]
    heads = ["rot_head.weight", "xyz_head.weight"]
    sizes = [int(np.prod(layout[k])) for k in kernels + heads]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, o = {}, 0
    for k, n in zip(kernels + heads, sizes):
        shape = layout[k]
        scale = head_std if k in heads else 1.0 / np.sqrt(np.prod(shape[1:]))
        out[k] = flat[o:o + n].reshape(shape) * scale
        o += n
    mid = {k: (ranges[k + "min"] + ranges[k + "max"]) / 2 for k in rt.RANGE_KEYS}
    R = rt.pose_deg(torch.tensor([[mid["alpha"], mid["beta"], mid["gamma"]]], dtype=torch.float64),
                    torch.zeros((1, 3), dtype=torch.float64))[0, :3, :3].numpy()
    for k, shape in layout.items():
        if k in out:
            continue
        if k == "rot_head.bias":
            out[k] = torch.as_tensor(rt.vec10(R), dtype=torch.float32, device=device)
        elif k == "xyz_head.bias":
            out[k] = torch.tensor([mid["tx"], mid["ty"], mid["tz"]], device=device) / unit
        elif k.endswith(".weight"):
            out[k] = torch.ones(shape, device=device)
        else:
            out[k] = torch.zeros(shape, device=device)
    return out


class Work:
    def __init__(self, config: dict, traffic: dict, seed: int, device="cuda"):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.dir = Path(tempfile.gettempdir()) / "portbench-subject"
        self.trainer_seed = (self.seed + 1) % 2**31  # the trainer's draws; the weights take --seed
        self.steps = 0
        self.compute_dtype = None  # the program's bf16 path, switched on for the control

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
        self.phases = dict(subject_s=t1 - t0, **self.phases)

    def subject(self) -> None:
        """The CT and its labelmap, written where the trainer reads them,
        and the weights, all from the seed."""
        cfg, dev = self.config, self.device
        if self.dir.exists():
            shutil.rmtree(self.dir)
        self.dir.mkdir(parents=True)
        hu, aff, _ = scene.build_ct(cfg["ct"]["size"], self.seed, dev)
        mask = scene.deepfluoro_mask(hu)
        scene.write_nifti(self.dir / "ct.nii", hu.cpu().numpy(), aff)
        scene.write_nifti(self.dir / "mask.nii", mask.cpu().numpy(), aff)
        self.affine, self.hu, self.mask = aff, hu.cpu(), mask.cpu()
        del hu, mask
        t = cfg["trainer"]
        self.ranges = {k: float(v) for k, v in t["ranges"].items()}
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        self.weights = make_weights(gen, rt.resnet34_layout(), self.ranges, cfg["head_std"],
                                    float(t["unit_conversion_factor"]), dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def system(self) -> None:
        """The system under test with the benchmark's weights, taken through
        the checked steps by the window's own call, which also build and
        warm everything; their target renders and the first step's CNN
        outputs are recorded on the way."""
        from xvr_tpu_torch.train.trainer import Trainer

        t, dev = self.config["trainer"], self.device
        t1 = time.perf_counter()
        trainer = Trainer(str(self.dir / "ct.nii"), str(self.dir / "mask.nii"),
                          str(self.dir / "train_out"), **self.ranges,
                          **{k: v for k, v in t.items() if k != "ranges"},
                          seed=self.trainer_seed, device=str(dev))
        have = {k: tuple(v.shape) for k, v in trainer.model.named_parameters()}
        if have != rt.resnet34_layout():
            raise RuntimeError("the trainer's model is not the ResNet-34 pose regressor the "
                               "benchmark makes weights for")
        trainer.model.load_state_dict(self.weights)
        if self.compute_dtype is not None:
            trainer.model.backbone.compute_dtype = self.compute_dtype
        self.trainer = trainer
        self.route = trainer.route()
        self.conv_tf32 = bool(torch.backends.cudnn.allow_tf32)
        t2 = time.perf_counter()
        self.losses, self.terms, self.renders, calls = [], [], [], []
        render_batch, apply_model = trainer.render_batch, trainer.apply_model

        def record(fn):
            def wrapped(*a, **kw):
                out = fn(*a, **kw)
                calls.append((fn, out))
                return out
            return wrapped

        trainer.render_batch, trainer.apply_model = record(render_batch), record(apply_model)
        try:
            for k in range(int(self.traffic["checked_steps"])):
                calls.clear()
                m = trainer.step(self.steps)
                self.steps += 1
                self.losses.append(float(m["loss"]))
                self.terms.append({t: float(m[t]) for t in TERMS})
                self.renders.append(next(o for f, o in calls if f == render_batch).detach().cpu())
                if k == 0:
                    self.cnn1 = tuple(v.detach().cpu() for v in
                                      next(o for f, o in calls if f == apply_model))
                    self.g1 = {n: (v / (1 - rt.B1)).clone()
                               for n, v in trainer.opt_state["mu"].items()}
        finally:
            del trainer.render_batch, trainer.apply_model
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
        return self._check()

    def _check(self):
        checks, info = self.compare((self.losses, self.terms, self.g1, self.p_end, self.renders,
                                     self.cnn1), self.reference_run("float32"))
        return checks, dict(setup_phases=self.phases, route=str(self.route), **info)

    def reference_run(self, precision: str):
        """The reference through the checked steps from the same weights on
        the same draws. -> (losses, the loss's terms, first gradient as Adam
        holds it, parameters after the steps, target renders, first CNN
        outputs)."""
        dev = self.device
        with ref.no_tf32():
            step = rt.Step(self.hu.to(dev), self.mask.to(dev), self.affine, self.config,
                           self.weights, precision)
            losses, terms, renders = [], [], []
            for k, d in enumerate(self._draws()):
                m = step(d)
                losses.append(m["loss"])
                terms.append({t: m[t] for t in TERMS})
                renders.append(step.raw.cpu())
                if k == 0:
                    g1 = {n: v / (1 - rt.B1) for n, v in step.state["mu"].items()}
                    cnn1 = tuple(v.cpu() for v in step.cnn_out)
        return losses, terms, g1, step.params, renders, cnn1

    def compare(self, run, reference):
        """``run`` against ``reference``, each (losses, the loss's terms,
        first gradient, parameters after the steps, target renders, first
        CNN outputs). -> (checks, info)."""
        (losses, terms, g1, p_end, renders, cnn1) = run
        (r_losses, r_terms, r_g1, r_end, r_renders, r_cnn1) = reference
        gn = {n: float(torch.linalg.norm(v)) for n, v in r_g1.items()}
        med_g = float(np.median(list(gn.values())))
        leaves = [n for n in gn if gn[n] >= 1e-3 * med_g]

        def gaps(a: dict, b: dict) -> dict:
            """{leaf: |norm(a) - norm(b)| / max(norm(b), the median leaf's
            norm(b))}"""
            na = {n: float(torch.linalg.norm(a[n].float())) for n in leaves}
            nb = {n: float(torch.linalg.norm(b[n].float())) for n in leaves}
            med = float(np.median(list(nb.values())))
            return {n: abs(na[n] - nb[n]) / max(nb[n], med, 1e-30) for n in leaves}

        def worst(g: dict):
            n = max(g, key=g.get)
            return n, g[n]

        g_gap = gaps(g1, r_g1)
        s_gap = gaps({n: p_end[n] - self.weights[n] for n in leaves},
                     {n: r_end[n] - self.weights[n] for n in leaves})
        rel = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(losses, r_losses)]
        r_gaps = [render_gaps(a, b) for a, b in zip(renders, r_renders)]
        c_gaps = [float(torch.linalg.norm(a.double() - b.double())
                        / torch.linalg.norm(b.double() - b.double().mean(dim=0)).clamp_min(1e-30))
                  for a, b in zip(cnn1, r_cnn1)]
        values = dict(loss1_gap=rel[0], mncc1_gap=abs(terms[0]["mncc"] - r_terms[0]["mncc"]),
                      dgeo1_gap=abs(terms[0]["dgeo"] - r_terms[0]["dgeo"]) / r_terms[0]["dgeo"],
                      grad_gap=worst(g_gap)[1], step_gap=worst(s_gap)[1],
                      render_gap=max(max(g) for g in r_gaps), cnn1_gap=max(c_gaps))
        lim = self.config["correct"]
        checks = {k: dict(value=values[k], limit=lim[k]) for k in lim}
        info = dict(values, loss=losses, loss_reference=r_losses, loss_gaps=rel,
                    terms=terms, terms_reference=r_terms,
                    leaves_compared=f"{len(leaves)} of {len(gn)}",
                    leaves_left_out=sorted(set(gn) - set(leaves)),
                    grad_worst_leaf=f"{worst(g_gap)[0]}: gap {worst(g_gap)[1]:.3g}, reference "
                                    f"norm {gn[worst(g_gap)[0]] / med_g:.3g} of the median leaf's",
                    grad_gap_median=float(np.median(list(g_gap.values()))),
                    step_worst_leaf=f"{worst(s_gap)[0]}: gap {worst(s_gap)[1]:.3g}",
                    step_gap_median=float(np.median(list(s_gap.values()))),
                    render_gaps=r_gaps, cnn1_gaps=dict(zip(("rot", "xyz"), c_gaps)))
        return checks, info

    def context(self) -> dict:
        t = self.config["trainer"]
        return dict(steps=self.window_steps, batch=int(t["batch_size"]), height=int(t["height"]),
                    first_pose=self._draws()[0]["pose"].cpu(), affine=self.affine,
                    ranges=self.ranges, route=self.route, vol_shape=tuple(self.hu.shape),
                    mask=self.mask, trainer_cfg=t,
                    conv_tf32=self.conv_tf32)
