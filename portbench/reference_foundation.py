"""The plain reference of the foundation cell, in PyTorch, float32, TF32 off.

xvr's patient-agnostic ("foundation") pretraining trains one pose network
over a directory of CTs. On top of :mod:`portbench.reference_train`'s step on
one CT, which it uses without editing, this file adds what several CTs
bring:

* padding: each subject padded at its far ends to the elementwise largest
  shape, with -1000 HU and label 0, its affine kept; the isocentre of a
  subject's poses is the padded grid's centre, as the program uses it;
* the labels as the union over the subjects (a subject that lacks a label
  renders a zero channel for it);
* the pick of a subject each step, a frozen copy of the program's
  ``Trainer._pick_subject`` (numpy's ``default_rng(seed).choice(n,
  p=uniform)``), as ``reference_train.draw`` freezes ``Trainer.draw``;
* one set of parameters and one optimizer state shared by every subject;
* optax's ``MultiSteps``: the running mean of the window's gradients,
  ``acc += (g - acc) / (n + 1)``, and on every ``every_k``-th gradient
  ``reference_train.agc_adam`` on that mean, with the warmup-cosine
  schedule over updates (``n_warmup_itrs / every_k``, ``n_total_itrs /
  every_k``), then the mean reset.

Departures from the published description: the subjects are the
benchmark's seeded phantoms, not DeepFluoro's six CTs; a subject is picked
by the program's generator, where the published trainer's data loader
orders its subjects itself; the subjects are padded as the program pads
them, where the published trainer renders each CT at its own shape. The
step on one subject is ``reference_train``'s, with its own departures.

Frozen: later changes to the benchmark may add beside this file, not edit it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import reference_train as rt


def pad(hu: torch.Tensor, mask: torch.Tensor, shape) -> tuple:
    """``hu`` and ``mask`` padded at their far ends to ``shape``, with -1000
    HU and label 0."""
    pads = []
    for t, s in zip(reversed(shape), reversed(hu.shape)):
        pads += [0, int(t) - int(s)]
    return F.pad(hu, pads, value=-1000), F.pad(mask, pads, value=0)


def picks(seed: int, n_subjects: int, steps: int) -> list:
    """The subjects of ``steps`` steps, as ``Trainer._pick_subject`` picks
    them from a generator seeded with ``seed`` (one subject: no draw)."""
    if n_subjects == 1:
        return [0] * steps
    rng = np.random.default_rng(seed)
    w = np.ones(n_subjects)
    return [int(rng.choice(n_subjects, p=w / w.sum())) for _ in range(steps)]


def targets(step: rt.Step, draws: dict):
    """The step's poses about the subject's isocentre, its channel stack and
    slab ranges, and its target renders (B, C, H, W), as
    ``reference_train.Step`` makes them."""
    dev = step.dev
    T = torch.eye(4, device=dev)
    T[:3, 3] = step.center.to(dev)
    pose = T @ draws["pose"].to(dev)
    stack, bounds = rt.channel_stack(rt.hu_to_density(step.hu, draws["contrast"].to(dev)),
                                     step.mask, step.labels, step.perm)
    with torch.no_grad():
        raw = rt.render_channels(stack, bounds, step.Ainv, pose, step.det, step.perm,
                                 step.precision)
    return pose, stack, bounds, raw


def loss_and_grads(step: rt.Step, draws: dict) -> tuple:
    """``reference_train.Step``'s step up to the gradients, without the
    update. -> (metrics, {name: gradient}); the step keeps ``raw`` and
    ``cnn_out`` as it does."""
    dev, t = step.dev, step.cfg
    H = step.det.height
    pose, stack, bounds, raw = targets(step, draws)
    with torch.no_grad():
        fg = (raw > 0).to(raw.dtype)
        img = raw.sum(dim=1, keepdim=True)
        if raw.shape[1] > 1:
            hit = (raw[:, 1:].sum(dim=1, keepdim=True) > 0).to(raw.dtype)
            keep = hit.mean(dim=(1, 2, 3)) > rt.MASK_THRESHOLD
        else:
            keep = fg.mean(dim=(1, 2, 3)) > rt.IMG_THRESHOLD
        keep = keep.to(img.dtype)
        aug = {k: v.to(dev) for k, v in draws["aug"].items()}
        x = rt.ref.xray_transform(rt.augment(img, aug), H, H)
    params = {k: v.requires_grad_(True) for k, v in step.params.items()}
    rot, xyz = rt.regress(params, x)
    step.raw, step.cnn_out = raw, (rot.detach(), xyz.detach())
    ppose = rt.decode(rot, xyz)
    praw = rt.render_channels(stack, bounds, step.Ainv, ppose, step.det, step.perm,
                              step.precision)
    pfg = (praw > 0).to(praw.dtype).detach()
    pimg = rt.ref.xray_transform(praw.sum(dim=1, keepdim=True), H, H)
    loss, terms = rt.loss_fn(rt.ref.xray_transform(img, H, H), fg, pose, pimg, pfg, ppose, keep,
                             t["sdd"], t["weight_ncc"], t["weight_geo"], t["weight_dice"])
    grads = torch.autograd.grad(loss, list(params.values()))
    for v in step.params.values():
        v.requires_grad_(False)
    metrics = dict(loss=float(loss.detach()), kept=float(keep.mean()), **terms)
    return metrics, dict(zip(params, grads))


class Foundation:
    """The reference trainer over several subjects: ``subjects`` is a list
    of (hu, mask, affine) at their own shapes, on the device they are
    computed on. Each call takes one step on the given draws and subject,
    and keeps that step's target renders (``raw``) and, after the first
    step, its CNN outputs (``cnn_out``); after the first update,
    ``first_update`` holds the mean gradient as Adam holds it (its first
    moment over 1 - b1: the clipped mean). ``every_k`` replaces the
    configuration's ``n_grad_accum_itrs`` (the control that skips the
    accumulation); ``precision`` as in ``reference_train.Step``."""

    def __init__(self, subjects: list, cfg: dict, params: dict, precision: str = "float32",
                 every_k: int | None = None):
        t = cfg["trainer"]
        shape = tuple(int(n) for n in np.max([tuple(hu.shape) for hu, _, _ in subjects], axis=0))
        labels = sorted({int(v) for _, mask, _ in subjects for v in torch.unique(mask).tolist()}
                        - {0})
        self.steps = []
        for hu, mask, affine in subjects:
            step = rt.Step(*pad(hu, mask, shape), affine, cfg, params, precision)
            step.labels = labels
            self.steps.append(step)
        self.shape, self.labels = shape, labels
        self.params, self.state = self.steps[0].params, self.steps[0].state
        for step in self.steps:
            step.params, step.state = self.params, self.state
        self.every_k = int(t["n_grad_accum_itrs"] if every_k is None else every_k)
        self.lr = rt.schedule(t["lr"], t["n_warmup_itrs"] / self.every_k,
                              t["n_total_itrs"] / self.every_k)
        self.acc = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.mini_step, self.updates = 0, 0
        self.raw = self.cnn_out = self.first_update = None

    def __call__(self, draws: dict, subject: int) -> dict:
        step = self.steps[subject]
        metrics, grads = loss_and_grads(step, draws)
        self.raw = step.raw
        if self.cnn_out is None:
            self.cnn_out = step.cnn_out
        return dict(metrics, updated=self.apply(grads))

    @torch.no_grad()
    def apply(self, grads: dict) -> bool:
        """Fold ``grads`` into the running mean and, on the ``every_k``-th,
        update the parameters from it. -> whether they moved."""
        n = self.mini_step
        for k, g in grads.items():
            self.acc[k] = self.acc[k] + (g - self.acc[k]) / float(n + 1)
        if n < self.every_k - 1:
            self.mini_step = n + 1
            return False
        rt.agc_adam(self.params, self.acc, self.state, self.lr(self.state["count"]))
        if self.first_update is None:
            self.first_update = {k: v / (1 - rt.B1) for k, v in self.state["mu"].items()}
        self.acc = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.mini_step, self.updates = 0, self.updates + 1
        return True
