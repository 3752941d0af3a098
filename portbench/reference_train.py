"""The plain reference of the training cells, in PyTorch, float32, TF32 off.

It imports nothing of the program. From the CT and the labelmap the
benchmark wrote, the weights it made and the draws it made, it works out one
step of ``Trainer.train_step`` again: the poses about the volume centre, the
attenuation with the step's bone contrast, the label-channel shear-warp
renders of the targets, the augmentations and the X-ray transforms, the
ResNet-34 (GroupNorm, flax's SAME padding) and its two pose heads, the
re-render at the predicted poses (differentiated through the renderer, the
slope grid, march sign and slab weights held constant), the composite loss
``(1 - mNCC) + Dice + 0.01 double geodesic`` over the kept samples, and
optax's ``adaptive_grad_clip(0.01, 1e-3)`` then Adam with the warmup-cosine
schedule. The definitions are those of the port's ``train/``, ``models/``,
``metrics/`` and ``render/shearwarp.py`` at commit 7233a73, and the draws
follow ``Trainer.draw`` and ``draw_augmentations`` in kind and order.

Frozen: later changes to the benchmark may add beside this file, not edit it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import reference as ref

RANGE_KEYS = ("alpha", "beta", "gamma", "tx", "ty", "tz")
IMG_THRESHOLD, MASK_THRESHOLD = 0.10, 0.05
ERASE_SCALE, ERASE_RATIO = (0.02, 0.33), (0.3, 3.3)
CLIPPING, AGC_EPS, B1, B2, EPS = 0.01, 1e-3, 0.9, 0.999, 1e-8
SLAB_CHUNK = 16  # slabs recomputed together in the backward

# ---------------------------------------------------------------------------
# poses and draws
# ---------------------------------------------------------------------------


def pose_deg(rot_deg: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """ZXY degrees and camera-frame translations (B, 3) -> (B, 4, 4)."""
    return ref.pose_zxy(torch.deg2rad(rot_deg), xyz)


def draw(gen: torch.Generator, ranges: dict, B: int, H: int, p: float, max_crop: int = 10) -> dict:
    """One step's draws, as ``Trainer.draw`` makes them on one stratum:
    ``pose`` (B, 4, 4) uniform on the ranges (angles wrapped to (-180,
    180]), ``contrast`` in [1, 10), ``aug`` the augmentations' draws."""
    dev = gen.device

    def u(*size):
        return torch.rand(size, generator=gen, device=dev)

    uni = u(B, 6)
    lo = torch.tensor([ranges[k + "min"] for k in RANGE_KEYS], device=dev)
    hi = torch.tensor([ranges[k + "max"] for k in RANGE_KEYS], device=dev)
    x = lo + uni * (hi - lo)
    rot = torch.remainder(x[:, :3] + 180.0, 360.0) - 180.0
    pose = pose_deg(rot, x[:, 3:])
    contrast = 1.0 + 9.0 * u()

    def take():
        return u(B) < p

    d = {}
    d["clip"], d["take_clahe"] = 1.0 + 9.0 * u(B), take()
    d["gamma"], d["take_gamma"] = 0.7 + 1.1 * u(B), take()
    d["take_blur"] = take()
    d["noise"] = 0.01 * torch.randn((B, 1, H, H), generator=gen, device=dev)
    d["take_noise"] = take()
    d["factor"], d["take_sharp"] = 0.5 * u(B), take()
    lo_r, hi_r = math.log(ERASE_RATIO[0]), math.log(ERASE_RATIO[1])
    d["take_erase"] = take()
    d["erase_area"] = (ERASE_SCALE[0] + (ERASE_SCALE[1] - ERASE_SCALE[0]) * u(B)) * H * H
    d["erase_log_r"] = lo_r + (hi_r - lo_r) * u(B)
    d["erase_top"], d["erase_left"] = u(B), u(B)
    d["take_crop"] = take()
    d["crop"] = torch.randint(0, max_crop + 1, (B,), generator=gen, device=dev)
    return dict(pose=pose, contrast=contrast, aug=d)


def mean_pose_R(ranges: dict) -> torch.Tensor:
    """The rotation at the middle of the angle ranges (1, 4, 4), which fixes
    the march axes of the step's renders."""
    mid = torch.tensor([[(ranges[k + "min"] + ranges[k + "max"]) / 2 for k in RANGE_KEYS[:3]]],
                       dtype=torch.float64)
    return pose_deg(mid, torch.zeros((1, 3), dtype=torch.float64))


# ---------------------------------------------------------------------------
# the CT's channels and their renders
# ---------------------------------------------------------------------------


def hu_to_density(hu: torch.Tensor, bone: torch.Tensor) -> torch.Tensor:
    """Piecewise HU -> attenuation with the bone (> 350 HU) scaled by
    ``bone``, min-max rescaled to [0, 1]."""
    v = hu.to(torch.float32)
    air = v <= -800.0
    soft_min = torch.where(air, torch.full_like(v, float("inf")), v).min()
    d = torch.where(air, soft_min, v)
    d = torch.where(v > 350.0, v * bone, d)
    d = d - d.min()
    return d / torch.clamp(d.max(), min=1e-12)


def channel_stack(density: torch.Tensor, mask: torch.Tensor, labels, perm):
    """The bf16 (C, M, Wd, L) stack in march order: the whole density, then
    the density inside each label; and each channel's slab range (the slabs
    a label reaches)."""
    vol = density.permute(*perm).contiguous().to(torch.bfloat16)
    m = mask.permute(*perm)
    chans, bounds = [vol], [(0, vol.shape[0])]
    for lab in labels:
        fg = m == int(lab)
        chans.append(vol * fg.to(torch.bfloat16))
        hit = torch.nonzero(fg.any(dim=2).any(dim=1)).flatten()
        bounds.append((int(hit[0]), int(hit[-1]) + 1) if hit.numel() else (0, 0))
    return torch.stack(chans), bounds


def render_channels(stack: torch.Tensor, bounds, affine_inverse, pose, det: ref.Detector,
                    perm, precision: str = "float32") -> torch.Tensor:
    """Channels [background, labels...] (B, C, H, W) of the stack at
    ``pose``; differentiable in ``pose`` (the slabs are recomputed in chunks
    in the backward). ``precision`` as in :func:`reference.accumulate`."""
    x = ref.slope_setup(affine_inverse, pose, det, perm)
    B, C = pose.shape[0], stack.shape[0]
    imgs = []
    for c in range(C):
        I = torch.zeros((B, *x["grid"]), dtype=torch.float32, device=stack.device)
        k0, k1 = bounds[c]
        for a in range(k0, k1, SLAB_CHUNK):
            b = min(a + SLAB_CHUNK, k1)

            def part(s, a=a, b=b, c=c):
                return ref.accumulate(stack[c], dict(x, s=s), a, b, precision)

            I = I + (checkpoint(part, x["s"], use_reentrant=False) if x["s"].requires_grad
                     else part(x["s"]))
        imgs.append(ref.warp(I, x["uc"], x["vc"], x["ws"]))
    out = torch.stack(imgs, dim=1).reshape(B, C, det.height, det.width)
    return torch.cat([out[:, :1] - out[:, 1:].sum(dim=1, keepdim=True), out[:, 1:]], dim=1)


# ---------------------------------------------------------------------------
# augmentations
# ---------------------------------------------------------------------------


def _standardize(x):
    lo = torch.amin(x, dim=(1, 2, 3), keepdim=True)
    hi = torch.amax(x, dim=(1, 2, 3), keepdim=True)
    return (x - lo) / (hi - lo + 1e-6)


def _depthwise(x, k):
    C = x.shape[1]
    k = k.to(dtype=x.dtype, device=x.device)
    return F.conv2d(x, k.expand(C, 1, *k.shape), padding=(k.shape[0] // 2, k.shape[1] // 2),
                    groups=C)


def clahe(x: torch.Tensor, clip_limit: torch.Tensor, grid: int = 8, n_bins: int = 64):
    """Contrast-limited adaptive histogram equalization of (B, 1, H, W)
    images in [0, 1]: per-tile histograms clipped at ``clip_limit`` times the
    mean count (the excess spread evenly), each pixel mapped through the
    bf16-rounded CDFs of the four tiles about its half-tile cell, weighted
    bilinearly."""
    B, _, H, W = x.shape
    grid = max(min(grid, H // 2, W // 2), 1)
    th, tw = H // grid, W // grid
    th2, tw2 = th // 2, tw // 2
    xq = x[:, 0]
    tiles = xq.reshape(B, grid, th, grid, tw).permute(0, 1, 3, 2, 4).reshape(B, grid * grid, th * tw)
    idx = torch.clamp((tiles * n_bins).to(torch.int32), 0, n_bins - 1).long()
    hist = torch.zeros((B, grid * grid, n_bins), dtype=torch.float32, device=x.device)
    hist.scatter_add_(2, idx, torch.ones_like(tiles, dtype=torch.float32))
    limit = clip_limit.to(torch.float32)[:, None, None] * ((th * tw) / n_bins)
    excess = torch.clamp(hist - limit, min=0.0).sum(dim=-1, keepdim=True)
    hist = torch.minimum(hist, limit) + excess / n_bins
    cdf = torch.cumsum(hist, dim=-1)
    cdf = (cdf / cdf[..., -1:]).reshape(B, grid, grid, n_bins)

    def axis(n_px, tile, half):
        cells = n_px // half
        lo, hi = np.zeros(cells, np.int64), np.zeros(cells, np.int64)
        frac = np.zeros((cells, half))
        for ci in range(cells):
            yy = (ci * half + np.arange(half) + 0.5) / tile - 0.5
            y0 = np.clip(np.floor(yy).astype(np.int64), 0, grid - 1)
            lo[ci], hi[ci] = y0[0], min(y0[0] + 1, grid - 1)
            frac[ci] = np.clip(yy - y0, 0.0, 1.0)
        return lo, hi, frac

    ylo, yhi, fy = axis(H, th, th2)
    xlo, xhi, fx = axis(W, tw, tw2)
    cy, cx = len(ylo), len(xlo)
    corner_y = np.broadcast_to(np.stack([ylo, ylo, yhi, yhi], 1)[:, None, :], (cy, cx, 4))
    corner_x = np.broadcast_to(np.stack([xlo, xhi, xlo, xhi], 1)[None, :, :], (cy, cx, 4))
    wy = np.stack([1.0 - fy, 1.0 - fy, fy, fy], -1)
    wx = np.stack([1.0 - fx, fx, 1.0 - fx, fx], -1)
    w = (wy[:, None, :, None, :] * wx[None, :, None, :, :]).reshape(cy * cx, th2 * tw2, 4)
    w = torch.as_tensor(w.astype(np.float32), device=x.device)
    cyt = torch.as_tensor(corner_y.reshape(-1, 4), device=x.device)
    cxt = torch.as_tensor(corner_x.reshape(-1, 4), device=x.device)
    corner_cdf = cdf[:, cyt, cxt, :].to(torch.bfloat16).to(torch.float32)
    cells = xq.reshape(B, cy, th2, cx, tw2).permute(0, 1, 3, 2, 4).reshape(B, cy * cx, th2 * tw2)
    bins = torch.clamp((cells * n_bins).to(torch.int32), 0, n_bins - 1).long()
    vals = torch.gather(corner_cdf, 3, bins[:, :, None, :].expand(-1, -1, 4, -1))
    v = (vals.transpose(2, 3) * w[None]).sum(dim=-1)
    return v.reshape(B, cy, cx, th2, tw2).permute(0, 1, 3, 2, 4).reshape(B, H, W)[:, None]


def augment(x: torch.Tensor, d: dict) -> torch.Tensor:
    """Standardize, then per sample (where its draw says so) CLAHE, gamma,
    a 3x3 box blur, Gaussian noise, sharpness, one erased rectangle and a
    zeroed border."""
    def maybe(take, a, b):
        return torch.where(take[:, None, None, None], a, b)

    H, W = x.shape[-2:]
    yy = torch.arange(H, dtype=x.dtype, device=x.device)[None, :, None]
    xx = torch.arange(W, dtype=x.dtype, device=x.device)[None, None, :]
    x = _standardize(x)
    x = maybe(d["take_clahe"], clahe(x, d["clip"]), x)
    x = maybe(d["take_gamma"], torch.clamp(x, min=1e-8) ** d["gamma"][:, None, None, None], x)
    x = maybe(d["take_blur"], _depthwise(x, torch.ones((3, 3)) / 9.0), x)
    x = maybe(d["take_noise"], x + d["noise"].to(x.dtype), x)
    sharp = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]]) / 13.0
    x = maybe(d["take_sharp"], x + d["factor"][:, None, None, None] * (x - _depthwise(x, sharp)), x)
    r = torch.exp(d["erase_log_r"])
    h = torch.clamp(torch.sqrt(d["erase_area"] * r), 1, H)
    w = torch.clamp(torch.sqrt(d["erase_area"] / r), 1, W)
    top, left = d["erase_top"] * (H - h), d["erase_left"] * (W - w)
    inside = ((yy >= top[:, None, None]) & (yy < (top + h)[:, None, None])
              & (xx >= left[:, None, None]) & (xx < (left + w)[:, None, None]))
    x = maybe(d["take_erase"], torch.where(inside[:, None], torch.zeros_like(x), x), x)
    c = d["crop"].to(x.dtype)[:, None, None]
    keep = (yy >= c) & (yy < H - c) & (xx >= c) & (xx < W - c)
    return maybe(d["take_crop"], torch.where(keep[:, None], x, torch.zeros_like(x)), x)


# ---------------------------------------------------------------------------
# the pose regressor
# ---------------------------------------------------------------------------

STAGES = (3, 4, 6, 3)  # ResNet-34


def resnet34_layout(n_angular: int = 10) -> dict:
    """{parameter name: shape} of the port's PoseRegressor with a ResNet-34
    GroupNorm backbone (one input channel)."""
    out = {"backbone.conv1.weight": (64, 1, 7, 7), "backbone.norm1.weight": (64,),
           "backbone.norm1.bias": (64,)}
    cin, i = 64, 0
    for s, n in enumerate(STAGES):
        f = 64 * 2 ** s
        for j in range(n):
            stride = 2 if s > 0 and j == 0 else 1
            convs = [(f, cin, 3, 3), (f, f, 3, 3)]
            if stride != 1 or cin != f:
                convs.append((f, cin, 1, 1))
            for k, shape in enumerate(convs):
                out[f"backbone.blocks.{i}.convs.{k}.weight"] = shape
                out[f"backbone.blocks.{i}.norms.{k}.weight"] = (f,)
                out[f"backbone.blocks.{i}.norms.{k}.bias"] = (f,)
            cin, i = f, i + 1
    out.update({"rot_head.weight": (n_angular, 512), "rot_head.bias": (n_angular,),
                "xyz_head.weight": (3, 512), "xyz_head.bias": (3,)})
    return out


def _same(x, w, stride):
    k = w.shape[-1]
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        out = -(-n // stride)
        total = max((out - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    if any(pads):
        x = F.pad(x, pads)
    return F.conv2d(x, w, None, stride)


def _gn(x, p, name):
    return F.group_norm(x, 32, p[name + ".weight"], p[name + ".bias"], 1e-6)


def regress(p: dict, x: torch.Tensor, unit: float = 1000.0):
    """(B, 1, H, W) -> (rot (B, 10), xyz (B, 3) mm)."""
    x = F.conv2d(x, p["backbone.conv1.weight"], None, 2, 3)
    x = F.max_pool2d(F.relu(_gn(x, p, "backbone.norm1")), 3, 2, padding=1)
    cin, i = 64, 0
    for s, n in enumerate(STAGES):
        f = 64 * 2 ** s
        for j in range(n):
            stride = 2 if s > 0 and j == 0 else 1
            b = f"backbone.blocks.{i}"
            y = F.relu(_gn(_same(x, p[b + ".convs.0.weight"], stride), p, b + ".norms.0"))
            y = _gn(_same(y, p[b + ".convs.1.weight"], 1), p, b + ".norms.1")
            if stride != 1 or cin != f:
                x = _gn(_same(x, p[b + ".convs.2.weight"], stride), p, b + ".norms.2")
            x = F.relu(y + x)
            cin, i = f, i + 1
    feats = x.mean(dim=(2, 3))
    rot = feats @ p["rot_head.weight"].T + p["rot_head.bias"]
    return rot, unit * (feats @ p["xyz_head.weight"].T + p["xyz_head.bias"])


def decode(rot: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """quaternion_adjugate: the 10 entries of q q^T (upper triangle, row by
    row) -> q from the row of the largest diagonal entry -> R; the pose is
    ``[R | R xyz]``."""
    ii, jj = torch.triu_indices(4, 4, device=rot.device)
    A = torch.zeros(rot.shape[:-1] + (4, 4), dtype=rot.dtype, device=rot.device)
    A[..., ii, jj] = rot
    A = A + A.transpose(-1, -2) - A * torch.eye(4, dtype=rot.dtype, device=rot.device)
    best = torch.argmax(torch.abs(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1)
    q = torch.gather(A, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    w, x, y, z = q.unbind(-1)
    rows = ((1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
            (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
            (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)))
    R = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    out = torch.zeros(rot.shape[:-1] + (4, 4), dtype=rot.dtype, device=rot.device)
    out[..., :3, :3], out[..., :3, 3], out[..., 3, 3] = R, (R @ xyz[..., None])[..., 0], 1.0
    return out


def vec10(R: np.ndarray) -> np.ndarray:
    """A rotation's quaternion_adjugate parameters (float64)."""
    R = np.asarray(R, np.float64)
    (a, b, c), (d, e, f), (g, h, i) = R
    K = np.array([[a + e + i, h - f, c - g, d - b],
                  [h - f, a - e - i, b + d, c + g],
                  [c - g, b + d, e - a - i, f + h],
                  [d - b, c + g, f + h, i - a - e]])
    q = np.linalg.eigh(K / 3.0)[1][:, -1]
    Q = np.outer(q, q)
    return Q[np.triu_indices(4)]


# ---------------------------------------------------------------------------
# loss and optimizer
# ---------------------------------------------------------------------------


def _dice_loss(p, t):
    B, C = p.shape[:2]
    p, t = p.reshape(B, C, -1), t.reshape(B, C, -1)
    inter = (p * t).sum(dim=2)[:, 1:]
    denom = (p.sum(dim=2) + t.sum(dim=2))[:, 1:]
    valid = denom > 0
    dice = torch.where(valid, 2.0 * inter / torch.clamp(denom, min=1e-12), torch.zeros_like(denom))
    n = valid.sum(dim=1)
    mean = dice.sum(dim=1) / torch.clamp(n, min=1)
    return torch.where(n > 0, 1.0 - mean, torch.zeros_like(mean))


def _double_geodesic(P, Q, sdd, eps=1e-6):
    ss = torch.sum((P[:, :3, :3] - Q[:, :3, :3]) ** 2, dim=(-2, -1))
    small = ss < 1e-24
    d = torch.sqrt(torch.where(small, torch.ones_like(ss), ss))
    ang = torch.where(small, torch.zeros_like(ss),
                      2.0 * torch.asin(torch.clamp(d / (2.0 * math.sqrt(2.0)), 0.0, 1.0 - eps)))
    r, t = sdd * ang, torch.linalg.norm(P[:, :3, 3] - Q[:, :3, 3], dim=-1)
    return torch.sqrt(r ** 2 + t ** 2)


def loss_fn(img, fg, pose, pimg, pfg, ppose, keep, sdd, w_ncc=1.0, w_geo=1e-2, w_dice=1.0):
    """-> (the loss, {mncc, dice, dgeo}: each term's mean over the kept
    samples)."""
    def mean(x):
        return (x * keep).sum() / torch.clamp(keep.sum(), min=1e-6)

    mncc = 0.5 * ref._global_ncc(img, pimg) + 0.5 * ref._local_ncc(img, pimg, 9)
    dice = _dice_loss(fg, pfg) if fg.shape[1] > 1 else torch.zeros_like(mncc)
    dgeo = _double_geodesic(pose, ppose, sdd)
    loss = mean(w_ncc * (1.0 - mncc) + w_dice * dice + w_geo * dgeo)
    return loss, {k: float(mean(v.detach())) for k, v in (("mncc", mncc), ("dice", dice),
                                                          ("dgeo", dgeo))}


def schedule(lr: float, warmup: int, total: int):
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, total, 0), in float32."""
    f = np.float32
    warmup, total = max(int(warmup), 1), max(int(total), int(warmup) + 1)

    def at(step):
        if step < warmup:
            return float(f(-lr) * (f(1.0) - f(max(step, 0)) / f(warmup)) + f(lr))
        t = f(min(step - warmup, total - warmup))
        cosine = f(0.5) * (f(1.0) + f(np.cos(np.float64(f(np.pi) * t / f(total - warmup)))))
        return float(f(lr) * cosine)

    return at


def _unit_norm(x):
    if sum(1 for n in x.shape if n != 1) <= 1:
        return torch.sqrt((x * x).sum()).expand(x.shape)
    axes = (1,) if x.ndim == 2 else (1, 2, 3)
    return torch.sqrt((x * x).sum(dim=axes, keepdim=True)).expand(x.shape)


@torch.no_grad()
def agc_adam(params: dict, grads: dict, state: dict, lr: float) -> None:
    """One update in place: unit-wise adaptive gradient clipping, then Adam
    (bias correction by the incremented count, eps outside the root)."""
    f = np.float32
    state["count"] += 1
    bc1 = f(1) - np.power(f(B1), f(state["count"]), dtype=f)
    bc2 = f(1) - np.power(f(B2), f(state["count"]), dtype=f)
    for k, p in params.items():
        g = grads[k]
        gn, mx = _unit_norm(g), CLIPPING * torch.clamp(_unit_norm(p), min=AGC_EPS)
        g = torch.where(gn < mx, g, g * (mx / torch.clamp(gn, min=1e-6)))
        state["mu"][k] = (1 - B1) * g + B1 * state["mu"][k]
        state["nu"][k] = (1 - B2) * (g * g) + B2 * state["nu"][k]
        p.add_(f(-lr) * ((state["mu"][k] / bc1) / (torch.sqrt(state["nu"][k] / bc2) + EPS)))


# ---------------------------------------------------------------------------
# one step
# ---------------------------------------------------------------------------


class Step:
    """The reference trainer: the CT's stack and geometry, fixed once; each
    call takes one step of its own parameters on the given draws, and keeps
    the step's target renders (``raw``) and CNN outputs (``cnn_out``). With
    ``precision="bfloat16"`` the renders round as :func:`reference.accumulate`
    says (the control)."""

    def __init__(self, hu, mask, affine: np.ndarray, cfg: dict, params: dict,
                 precision: str = "float32"):
        t = cfg["trainer"]
        self.precision = precision
        self.dev = hu.device
        self.hu, self.cfg = hu, t
        self.labels = sorted(int(v) for v in torch.unique(mask).tolist() if v != 0)
        self.mask = mask
        self.Ainv = torch.as_tensor(np.linalg.inv(affine), dtype=torch.float32, device=self.dev)
        idx = (torch.tensor(hu.shape, dtype=torch.float64) - 1.0) / 2.0
        A = torch.as_tensor(affine)
        self.center = (A[:3, :3] @ idx + A[:3, 3]).to(torch.float32)
        self.det = ref.Detector(t["sdd"], t["height"], t["height"], t["delx"], t["delx"])
        ranges = {k: float(v) for k, v in t["ranges"].items()}
        self.perm = ref.permutation(mean_pose_R(ranges).float(), np.linalg.inv(affine))
        self.params = {k: v.detach().clone().to(self.dev) for k, v in params.items()}
        self.state = dict(count=0, mu={k: torch.zeros_like(v) for k, v in self.params.items()},
                          nu={k: torch.zeros_like(v) for k, v in self.params.items()})
        self.lr = schedule(t["lr"], t["n_warmup_itrs"] / t["n_grad_accum_itrs"],
                           t["n_total_itrs"] / t["n_grad_accum_itrs"])

    def __call__(self, draws: dict) -> dict:
        dev, t = self.dev, self.cfg
        T = torch.eye(4, device=dev)
        T[:3, 3] = self.center.to(dev)
        pose = T @ draws["pose"].to(dev)
        stack, bounds = channel_stack(hu_to_density(self.hu, draws["contrast"].to(dev)), self.mask,
                                      self.labels, self.perm)
        H = self.det.height
        with torch.no_grad():
            raw = render_channels(stack, bounds, self.Ainv, pose, self.det, self.perm,
                                  self.precision)
            fg = (raw > 0).to(raw.dtype)
            img = raw.sum(dim=1, keepdim=True)
            if raw.shape[1] > 1:
                hit = (raw[:, 1:].sum(dim=1, keepdim=True) > 0).to(raw.dtype)
                keep = hit.mean(dim=(1, 2, 3)) > MASK_THRESHOLD
            else:
                keep = fg.mean(dim=(1, 2, 3)) > IMG_THRESHOLD
            keep = keep.to(img.dtype)
            aug = {k: v.to(dev) for k, v in draws["aug"].items()}
            x = ref.xray_transform(augment(img, aug), H, H)
        params = {k: v.requires_grad_(True) for k, v in self.params.items()}
        rot, xyz = regress(params, x)
        self.raw, self.cnn_out = raw, (rot.detach(), xyz.detach())
        ppose = decode(rot, xyz)
        praw = render_channels(stack, bounds, self.Ainv, ppose, self.det, self.perm,
                               self.precision)
        pfg = (praw > 0).to(praw.dtype).detach()
        pimg = ref.xray_transform(praw.sum(dim=1, keepdim=True), H, H)
        loss, terms = loss_fn(ref.xray_transform(img, H, H), fg, pose, pimg, pfg, ppose, keep,
                              t["sdd"])
        grads = torch.autograd.grad(loss, list(params.values()))
        for v in self.params.values():
            v.requires_grad_(False)
        agc_adam(self.params, dict(zip(params, grads)), self.state, self.lr(self.state["count"]))
        return dict(loss=float(loss.detach()), kept=float(keep.mean()), **terms)
