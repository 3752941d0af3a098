"""Operations and bytes of the registrar's work, counted from shapes, and
the card's published peaks.

Frozen copies of ``chip_smoke.py::sw_bounds`` and ``active_samples``
(commit 7233a73): each input byte is read once and each output byte written
once; K1 (``sw_accumulate``) counts 8 and K4 (``sw_accumulate_adjoint``) 16
float32 operations per sample it evaluates (a slab in front of the source
whose window and lane positions touch the volume), K2 (``sw_warp``) 12 and
K3 (``sw_warp_grads``) 16 per detector pixel. The similarity's operations
are counted from its definition (:func:`similarity_ops`).

Frozen: later changes to the benchmark may add beside this file, not edit it.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from . import reference as ref

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
HBM = PEAKS["hbm_bytes_per_s"]
F32 = PEAKS["f32_flops"]
SW_KERNELS = ("sw_accumulate", "sw_warp", "sw_warp_grads", "sw_accumulate_adjoint")


def active_samples(vol_shape, x: dict, k0: int = 0, k1: int | None = None) -> int:
    """(b, i, j, k) samples that K1/K4 evaluate for one call on the rays
    of ``x`` (:func:`reference.slope_setup`) over the slabs [k0, k1)."""
    M, Wd, L = vol_shape
    k1 = M if k1 is None else k1
    Iu, Iv = x["grid"]
    dev = x["s"].device
    k = torch.arange(k0, k1, device=dev, dtype=torch.float32)
    c = k[None, :] - x["s"][:, 0:1]
    wk = torch.clamp(x["sgn"][:, None] * c + 0.5, 0.0, 1.0) > 0
    u = x["u0"][:, None] + x["du"][:, None] * torch.arange(Iu, device=dev)
    v = x["v0"][:, None] + x["dv"][:, None] * torch.arange(Iv, device=dev)
    wpos = x["s"][:, 1, None, None] + c[:, :, None] * u[:, None, :]
    lpos = x["s"][:, 2, None, None] + c[:, :, None] * v[:, None, :]
    nw = ((wpos > -1) & (wpos < Wd)).sum(-1)
    nl = ((lpos > -1) & (lpos < L)).sum(-1)
    return int((wk * nw * nl).sum())


def sw_calls(vol_shape, x: dict, k0: int = 0, k1: int | None = None) -> dict:
    """{kernel: (bytes, float32 operations)} of one call of each of K1-K4
    on the B rays of ``x``, K1 and K4 over the slabs [k0, k1)."""
    M, Wd, L = vol_shape
    k1 = M if k1 is None else k1
    B, R = x["uc"].shape
    Iu, Iv = x["grid"]
    vol_b = (k1 - k0) * Wd * L * 2
    act = active_samples(vol_shape, x, k0, k1)
    return {
        "sw_accumulate": (vol_b + B * 8 * 4 + B * Iu * Iv * 4, 8 * act),
        "sw_accumulate_adjoint": (vol_b + B * Iu * Iv * 2 + B * 8 * 4 + B * (Iu + Iv) * 4, 16 * act),
        "sw_warp": (B * Iu * Iv * 4 + 4 * B * R * 4, 12 * B * R),
        "sw_warp_grads": (B * Iu * Iv * 4 + 6 * B * R * 4, 16 * B * R),
    }


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: bytes at HBM bandwidth or
    float32 operations at the float32 peak, whichever is longer."""
    return max(nbytes / HBM, ops / F32)


def similarity_ops(H: int, W: int, mncc_patch: int = 9, gncc_patch: int = 11) -> int:
    """Float32 operations of one image's similarity at H x W, forward and
    backward (the backward counted as twice the forward): the render's
    transform (min-max and normalize, 4 per pixel), global NCC (10), local
    NCC over p x p windows (5 maps, 5 p^2 window sums, 19 elementwise), the
    two Sobel filters of both images (72), and the local NCC of the two
    gradient channels."""
    def local(p):
        return 19 + 5 * p * p

    fwd = 4 + 10 + local(mncc_patch) + 72 + 2 * local(gncc_patch)
    return 3 * fwd * H * W


def stage_work(vol_shape, affine_inverse, pose, det: ref.Detector, perm, n_done: int) -> dict:
    """Launches, bound seconds and operations of one pyramid stage that ran
    ``n_done`` iterations on the poses ``pose`` (K, 4, 4) at ``det``: each
    iteration renders (K1, K2) and differentiates (K3, K4) once, and the
    stage scores its last iterate with one more render."""
    x = ref.slope_setup(affine_inverse, pose, det, perm)
    calls = sw_calls(vol_shape, x)
    launches = {"sw_accumulate": n_done + 1, "sw_warp": n_done + 1,
                "sw_warp_grads": n_done, "sw_accumulate_adjoint": n_done}
    bound = sum(launches[k] * bound_s(*calls[k]) for k in SW_KERNELS)
    ops = sum(launches[k] * calls[k][1] for k in SW_KERNELS)
    K = pose.shape[0]
    sim = similarity_ops(det.height, det.width)
    ops += K * (n_done * sim + (n_done + 1) * sim // 3)
    return dict(launches=launches, bound_s=bound, ops=ops)


def window_work(ctx: dict) -> dict:
    """The registrar's work over a window (``ctx`` from a register driver):
    iterations and stage seconds summed over every stage of every pass of
    every request, X-rays registered, and K1-K4's bound seconds and the
    float32 operations of those stages, counted at each request's
    ground-truth views repeated over the restart seeds."""
    if "_window_work" in ctx:
        return ctx["_window_work"]
    n_done = seconds = xrays = bound = ops = 0
    dets = {d.height: d for d in ctx["stage_dets"]}
    for req in ctx["requests"]:
        xrays += len(req["gt"])
        gt = torch.as_tensor(req["gt"], dtype=torch.float32)
        pose = gt.repeat_interleave(ctx["restart_seeds"], dim=0)
        perm = ref.permutation(gt, ctx["affine_inverse"].numpy())
        for st in req["stages"]:
            n_done += st["n_done"]
            seconds += st["seconds"]
            w = stage_work(ctx["vol_shape"], ctx["affine_inverse"], pose, dets[st["height"]], perm,
                           st["n_done"])
            bound += w["bound_s"]
            ops += w["ops"]
    ctx["_window_work"] = dict(n_done=n_done, seconds=seconds, xrays=xrays, bound_s=bound, ops=ops)
    return ctx["_window_work"]


def resnet_flops(H: int, W: int, stages=(3, 4, 6, 3), in_chans: int = 1, n_out: int = 13) -> int:
    """Forward float operations (two per multiply-add) of one image through
    the pose regressor's convolutions and heads: a ResNet of BasicBlocks
    (ResNet-34 by default) with a 7x7 stride-2 stem, a stride-2 max-pool,
    flax's SAME padding, and linear heads of ``n_out`` outputs in all."""
    h, w = (H + 6 - 7) // 2 + 1, (W + 6 - 7) // 2 + 1
    flops = 2 * in_chans * 64 * 49 * h * w
    h, w = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1
    cin = 64
    for s, n in enumerate(stages):
        f = 64 * 2 ** s
        for j in range(n):
            stride = 2 if s > 0 and j == 0 else 1
            h, w = -(-h // stride), -(-w // stride)
            flops += 2 * 9 * h * w * (cin * f + f * f)
            if stride != 1 or cin != f:
                flops += 2 * h * w * cin * f
            cin = f
    return flops + 2 * cin * n_out


def train_step_work(ctx: dict) -> dict:
    """K1-K4's bound seconds and the operations of one training step (the
    CNN forward and backward, three times the forward, and K1-K4), counted
    at the first checked step's poses: per channel of the labelmap stack K1
    twice (the targets and the re-render) and K4 once over the channel's
    slabs, K2 twice and K3 once over the channels' fold."""
    if "_train_step_work" in ctx:
        return ctx["_train_step_work"]
    t = ctx["trainer_cfg"]
    det = ref.Detector(t["sdd"], t["height"], t["height"], t["delx"], t["delx"])
    aff = np.asarray(ctx["affine"], np.float64)
    Ainv = torch.as_tensor(np.linalg.inv(aff), dtype=torch.float32)
    idx = (np.asarray(ctx["vol_shape"], np.float64) - 1.0) / 2.0
    T = torch.eye(4)
    T[:3, 3] = torch.as_tensor(aff[:3, :3] @ idx + aff[:3, 3], dtype=torch.float32)
    pose = T @ ctx["first_pose"].float()
    mid = torch.tensor([[(ctx["ranges"][k + "min"] + ctx["ranges"][k + "max"]) / 2
                         for k in ("alpha", "beta", "gamma")]], dtype=torch.float64)
    perm = ref.permutation(ref.pose_zxy(torch.deg2rad(mid), torch.zeros((1, 3), dtype=torch.float64)),
                           np.linalg.inv(aff))
    shape = tuple(ctx["vol_shape"][p] for p in perm)
    m = ctx["mask"].permute(*perm)
    labels = sorted(int(v) for v in torch.unique(m).tolist() if v != 0)
    ranges = [(0, shape[0])]
    for lab in labels:
        hit = torch.nonzero((m == lab).any(dim=2).any(dim=1)).flatten()
        ranges.append((int(hit[0]), int(hit[-1]) + 1) if hit.numel() else (0, 0))
    x = ref.slope_setup(Ainv, pose, det, perm)
    C = len(ranges)
    bound = ops = 0.0
    for k0, k1 in ranges:
        calls = sw_calls(shape, x, k0, k1)
        bound += 2 * bound_s(*calls["sw_accumulate"]) + bound_s(*calls["sw_accumulate_adjoint"])
        ops += 2 * calls["sw_accumulate"][1] + calls["sw_accumulate_adjoint"][1]
    warp, grads = calls["sw_warp"], calls["sw_warp_grads"]
    bound += 2 * bound_s(C * warp[0], C * warp[1]) + bound_s(C * grads[0], C * grads[1])
    ops += C * (2 * warp[1] + grads[1])
    ops += 3 * ctx["batch"] * resnet_flops(t["height"], t["height"])
    ctx["_train_step_work"] = dict(bound_s=bound, ops=ops)
    return ctx["_train_step_work"]
