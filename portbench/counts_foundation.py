"""Operations and bytes of the foundation cell's training steps, counted
from shapes on each step's subject at its own, unpadded shape.

A step on subject ``s`` counts what ``counts.train_step_work`` counts for a
step on one CT (the CNN forward and backward, three times the forward; per
label channel K1 twice and K4 once over the channel's slabs; K2 twice and
K3 once over the channels' fold), at the first checked step's poses about
the subject's isocentre (the padded grid's centre, as the program renders
it), with the samples, slabs and label ranges of the subject's own voxels:
the padding the program marches is left out, so a change that stops
marching it raises the kernels' share and leaves the counted work as it
is. A label the subject lacks adds no K1/K4 work; K2/K3 fold every channel
of the labels' union, as the program renders them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference as ref
from .counts import bound_s, resnet_flops, sw_calls


def subject_step_work(ctx: dict, s: int) -> dict:
    """K1-K4's bound seconds and the operations of one step on subject
    ``s`` (``ctx`` from the foundation driver)."""
    cache = ctx.setdefault("_subject_step_work", {})
    if s in cache:
        return cache[s]
    t = ctx["trainer_cfg"]
    det = ref.Detector(t["sdd"], t["height"], t["height"], t["delx"], t["delx"])
    aff = np.asarray(ctx["affines"][s], np.float64)
    Ainv = torch.as_tensor(np.linalg.inv(aff), dtype=torch.float32)
    idx = (np.asarray(ctx["padded_shape"], np.float64) - 1.0) / 2.0
    T = torch.eye(4)
    T[:3, 3] = torch.as_tensor(aff[:3, :3] @ idx + aff[:3, 3], dtype=torch.float32)
    pose = T @ ctx["first_pose"].float()
    mid = torch.tensor([[(ctx["ranges"][k + "min"] + ctx["ranges"][k + "max"]) / 2
                         for k in ("alpha", "beta", "gamma")]], dtype=torch.float64)
    mean_pose = ref.pose_zxy(torch.deg2rad(mid), torch.zeros((1, 3), dtype=torch.float64))
    perm = ref.permutation(mean_pose, np.linalg.inv(aff))
    shape = tuple(ctx["subject_shapes"][s][p] for p in perm)
    m = ctx["masks"][s].permute(*perm)
    labels = sorted({int(v) for mask in ctx["masks"] for v in torch.unique(mask).tolist()} - {0})
    ranges = [(0, shape[0])]
    for lab in labels:
        hit = torch.nonzero((m == lab).any(dim=2).any(dim=1)).flatten()
        ranges.append((int(hit[0]), int(hit[-1]) + 1) if hit.numel() else (0, 0))
    x = ref.slope_setup(Ainv, pose, det, perm)
    C = len(ranges)
    bound = ops = 0.0
    for k0, k1 in ranges:
        if k1 <= k0:
            continue
        calls = sw_calls(shape, x, k0, k1)
        bound += 2 * bound_s(*calls["sw_accumulate"]) + bound_s(*calls["sw_accumulate_adjoint"])
        ops += 2 * calls["sw_accumulate"][1] + calls["sw_accumulate_adjoint"][1]
    warp, grads = calls["sw_warp"], calls["sw_warp_grads"]
    bound += 2 * bound_s(C * warp[0], C * warp[1]) + bound_s(C * grads[0], C * grads[1])
    ops += C * (2 * warp[1] + grads[1])
    ops += 3 * ctx["batch"] * resnet_flops(t["height"], t["height"])
    cache[s] = dict(bound_s=bound, ops=ops)
    return cache[s]


def window_work(ctx: dict) -> dict | None:
    """K1-K4's bound seconds and the operations of the window's steps,
    each on its own subject; None without the window's picks."""
    picks = ctx.get("window_picks")
    if not picks:
        return None
    bound = ops = 0.0
    for s in picks:
        w = subject_step_work(ctx, s)
        bound += w["bound_s"]
        ops += w["ops"]
    return dict(bound_s=bound, ops=ops)
