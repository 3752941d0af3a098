"""The plain reference of the register cells, in PyTorch, on any device.

It imports nothing of the program. From the CT, the labelmap and the X-ray
pixels that the benchmark wrote, it works out again what the registrar
computes at a pose: the X-ray's preprocessing (``--crop``, min-max,
``--linearize``), the masked CT's attenuation, the shear-warp line integrals
of one pyramid stage's detector, the X-ray transforms and the similarity
``beta * mNCC + (1 - beta) * gNCC``. The arithmetic follows the published
definitions of the port's renderer (``xvr_tpu_torch/render/shearwarp.py``,
``geometry/``, ``metrics/ncc.py``, ``utils/transforms.py`` at commit
7233a73): the volume is read in bfloat16, as the configuration states, and
everything after it runs in float32 with TF32 off (``precision="float32"``)
or, for the benchmark's control, with the hat factors, their partial products
and the slope image rounded to bfloat16 (``precision="bfloat16"``), the step
a kernel that moved the march onto tensor cores would take.

Frozen: later changes to the benchmark may add beside this file, not edit it.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F

MAX_LANE = 1536  # the slope grid's extent cap


@contextmanager
def no_tf32():
    """Within the block, matrix products and convolutions run in float32,
    TF32 off (the reference's precision); the flags are restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def _axis(axis: str, a: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    rows = {"X": ((o, z, z), (z, c, -s), (z, s, c)),
            "Y": ((c, z, s), (z, o, z), (-s, z, c)),
            "Z": ((c, -s, z), (s, c, z), (z, z, o))}[axis]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def pose_zxy(rot: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """ZXY Euler angles (radians) and the camera-frame translation, (B, 3)
    each -> (B, 4, 4) camera-to-world matrices ``[R | R xyz]``."""
    R = _axis("Z", rot[:, 0]) @ _axis("X", rot[:, 1]) @ _axis("Y", rot[:, 2])
    t = (R @ xyz[..., None])[..., 0]
    out = torch.zeros((rot.shape[0], 4, 4), dtype=rot.dtype, device=rot.device)
    out[:, :3, :3], out[:, :3, 3], out[:, 3, 3] = R, t, 1.0
    return out


def fiducial_mtre(pose: np.ndarray, gt: np.ndarray, fids: np.ndarray) -> float:
    """Mean 3D distance (mm) between the fiducials carried through the
    inverse of ``pose`` and through that of ``gt``, in float64."""
    Mi = np.linalg.inv(np.asarray(pose, np.float64).reshape(4, 4))
    Gi = np.linalg.inv(np.asarray(gt, np.float64).reshape(4, 4))
    a = fids @ Gi[:3, :3].T + Gi[:3, 3]
    b = fids @ Mi[:3, :3].T + Mi[:3, 3]
    return float(np.linalg.norm(a - b, axis=-1).mean())


def projection_distance(pose: np.ndarray, gt: np.ndarray, fids: np.ndarray, sdd: float) -> float:
    """Mean distance (mm, in the detector plane) between the fiducials'
    perspective projections through ``pose`` and through ``gt``, float64:
    each point is taken to the camera frame and scaled onto the plane at
    ``-sdd`` along the beam."""
    def project(m):
        Mi = np.linalg.inv(np.asarray(m, np.float64).reshape(4, 4))
        cam = fids @ Mi[:3, :3].T + Mi[:3, 3]
        return cam[:, [0, 2]] * (-sdd / cam[:, 1:2])

    return float(np.linalg.norm(project(pose) - project(gt), axis=-1).mean())


class Detector:
    """A C-arm detector: the source at the camera origin, the detector plane
    at y = -sdd, image rows along -z (spacing ``delx``), columns along +x
    (spacing ``dely``)."""

    def __init__(self, sdd, height, width, delx, dely, x0=0.0, y0=0.0):
        self.sdd, self.height, self.width = float(sdd), int(height), int(width)
        self.delx, self.dely, self.x0, self.y0 = float(delx), float(dely), float(x0), float(y0)

    def rescale(self, factor: float) -> "Detector":
        h = max(int(round(self.height / factor)), 1)
        w = max(int(round(self.width / factor)), 1)
        return Detector(self.sdd, h, w, self.delx * self.height / h, self.dely * self.width / w,
                        self.x0, self.y0)

    def rays(self, pose: torch.Tensor):
        """(B, 4, 4) poses -> world source (B, 1, 3) and targets (B, H*W, 3)."""
        dt, dev = pose.dtype, pose.device
        i = torch.arange(self.height, dtype=dt, device=dev)
        j = torch.arange(self.width, dtype=dt, device=dev)
        v = (i - (self.height - 1) / 2.0) * self.delx + self.y0
        u = (j - (self.width - 1) / 2.0) * self.dely + self.x0
        x = u[None, :].expand(self.height, self.width)
        z = (-v)[:, None].expand(self.height, self.width)
        y = torch.full((self.height, self.width), -self.sdd, dtype=dt, device=dev)
        cam = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
        R, t = pose[:, :3, :3], pose[:, :3, 3]
        target = cam[None] @ R.transpose(-1, -2) + t[:, None, :]
        return t[:, None, :], target


def stage_detectors(det: Detector, scales, crop: int) -> list:
    """The registrar's pyramid: stage ``x`` renders the cropped detector
    coarsened by ``x * H / (H + crop)``."""
    return [det.rescale(float(x) * det.height / (det.height + crop)) for x in scales]


def permutation(pose: torch.Tensor, affine_inverse: np.ndarray) -> tuple:
    """(march, window, lane) volume axes: the march axis is the dominant
    beam direction of the mean pose, the lane axis the transverse axis most
    aligned with the detector columns."""
    A = np.asarray(affine_inverse, np.float64)[:3, :3]
    R = pose[:, :3, :3].double().cpu().numpy().mean(axis=0)
    beam, cols = A @ (R @ [0.0, -1.0, 0.0]), A @ (R @ [1.0, 0.0, 0.0])
    march = int(np.argmax(np.abs(beam)))
    rest = [a for a in range(3) if a != march]
    lane = rest[int(np.argmax([abs(cols[a]) for a in rest]))]
    return march, (rest[0] if lane == rest[1] else rest[1]), lane


# ---------------------------------------------------------------------------
# attenuation
# ---------------------------------------------------------------------------


def hu_to_density(hu: torch.Tensor) -> torch.Tensor:
    """Piecewise HU -> attenuation, min-max rescaled to [0, 1]: air (<= -800
    HU) takes the soft-tissue minimum, bone (> 350 HU) keeps its value."""
    v = hu.to(torch.float32)
    air = v <= -800.0
    soft_min = torch.where(air, torch.full_like(v, float("inf")), v).min()
    if not torch.isfinite(soft_min):
        soft_min = torch.tensor(-800.0, device=v.device)
    d = torch.where(air, soft_min, v)
    d = d - d.min()
    return d / torch.clamp(d.max(), min=1e-12)


def kept_hu(hu: torch.Tensor, mask: torch.Tensor, labels) -> torch.Tensor:
    """The CT as ``-m mask --labels ...`` reads it: air outside the labels."""
    keep = torch.isin(mask.to(torch.int64), torch.tensor(list(labels), device=mask.device))
    return torch.where(keep, hu.to(torch.float32), torch.full_like(hu, -1000.0, dtype=torch.float32))


# ---------------------------------------------------------------------------
# shear-warp line integrals
# ---------------------------------------------------------------------------


def _hat(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(x), 0.0, 1.0)


def slope_setup(affine_inverse: torch.Tensor, pose: torch.Tensor, det: Detector, perm) -> dict:
    """A render's rays in slope space: the permuted voxel-space source ``s``
    (B, 3), the march sign, the slope grid ``(u0, du, v0, dv)`` fitted to
    the rays with a two-cell margin on an (Iu, Iv) grid, each pixel's grid
    coordinates ``(uc, vc)`` and its path factor ``ws`` (B, R)."""
    f = torch.float32
    src, tgt = det.rays(pose.to(f))
    A = affine_inverse.to(f)
    s_vox = src @ A[:3, :3].T + A[:3, 3]
    t_vox = tgt @ A[:3, :3].T + A[:3, 3]
    d_vox = t_vox - s_vox.expand(t_vox.shape)
    raylen = torch.linalg.norm(tgt - src.expand(tgt.shape), dim=-1)
    order = list(perm)
    s_p, d_p = s_vox[..., order][:, 0, :], d_vox[..., order]
    ws = raylen / torch.clamp(torch.abs(d_p[..., 0]), min=1e-6)
    d0 = d_p[..., 0]
    d0 = torch.where(torch.abs(d0) < 1e-6, torch.full_like(d0, 1e-6), d0)
    u, v = d_p[..., 1] / d0, d_p[..., 2] / d0
    Iu = min(max(-(-det.height // 128) * 128, 128), MAX_LANE)
    Iv = min(max(-(-det.width // 128) * 128, 128), MAX_LANE)

    def fit(lo, hi, n):
        step = torch.clamp(hi - lo, min=1e-6) / (n - 5)
        return lo - 2.0 * step, step

    # the grid and the march sign are constants of the render: no gradient
    u0, du = (x.detach() for x in fit(u.min(dim=1).values, u.max(dim=1).values, Iu))
    v0, dv = (x.detach() for x in fit(v.min(dim=1).values, v.max(dim=1).values, Iv))
    return dict(s=s_p, sgn=torch.sign(d_p[..., 0].mean(dim=1)).detach(), u0=u0, du=du, v0=v0, dv=dv,
                uc=(u - u0[:, None]) / du[:, None], vc=(v - v0[:, None]) / dv[:, None], ws=ws,
                grid=(Iu, Iv))


def accumulate(vol: torch.Tensor, x: dict, k0: int = 0, k1: int | None = None,
               precision: str = "float32") -> torch.Tensor:
    """The slope image (B, Iu, Iv) of the bf16 volume ``vol`` ((M, Wd, L),
    in march order) over the slabs [k0, k1), on the rays of ``x``
    (:func:`slope_setup`): ``I[b, i, j] = sum_k w_k sum_{w,l}
    hat(wpos - w) hat(lpos - l) vol[k, w, l]`` with the ray at window
    ``s1 + (k - s0) u_i`` and lane ``s2 + (k - s0) v_j`` at slab k and
    ``w_k = clip(sgn (k - s0) + 1/2, 0, 1)`` (a constant of the render)."""
    f = torch.float32
    rnd = (lambda t: t.to(torch.bfloat16).to(f)) if precision == "bfloat16" else (lambda t: t)
    s_p, sgn = x["s"], x["sgn"]
    Iu, Iv = x["grid"]
    M, Wd, L = vol.shape
    k1 = M if k1 is None else k1
    dev = vol.device
    iw, il = torch.arange(Wd, dtype=f, device=dev), torch.arange(L, dtype=f, device=dev)
    ug = x["u0"][:, None] + x["du"][:, None] * torch.arange(Iu, dtype=f, device=dev)
    vg = x["v0"][:, None] + x["dv"][:, None] * torch.arange(Iv, dtype=f, device=dev)
    I = torch.zeros((s_p.shape[0], Iu, Iv), dtype=f, device=dev)
    for k in range(k0, k1):
        c = float(k) - s_p[:, 0]
        wk = torch.clamp(sgn * c.detach() + 0.5, 0.0, 1.0)
        wpos = s_p[:, 1, None] + c[:, None] * ug
        lpos = s_p[:, 2, None] + c[:, None] * vg
        aw = rnd(rnd(_hat(wpos[..., None] - iw)) * rnd(wk)[:, None, None])
        bl = rnd(_hat(lpos[..., None] - il))
        I = I + rnd(aw @ vol[k].to(f)) @ bl.transpose(1, 2)
    return rnd(I)


def warp(I: torch.Tensor, uc: torch.Tensor, vc: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """The slope image (B, Iu, Iv) sampled bilinearly at each pixel's grid
    coordinates (B, R), zero outside the grid, times the path factor."""
    f = torch.float32
    B, Iu, Iv = I.shape
    valid = (uc > -1.0) & (uc < Iu) & (vc >= 0.0) & (vc <= Iv - 1.0) & (ws > 0.0)
    ucs = torch.where(valid, uc, torch.zeros_like(uc))
    vcs = torch.where(valid, vc, torch.zeros_like(vc))
    j0 = torch.clamp(vcs.detach().to(torch.int64), 0, max(Iv - 2, 0))
    fx = torch.clamp(vcs - j0.to(f), 0.0, 1.0)
    j1 = torch.clamp(j0 + 1, max=Iv - 1)
    flat = I.reshape(B, Iu * Iv)
    z0 = torch.floor(ucs.detach())
    out = torch.zeros_like(uc)
    for dz in (0, 1):
        z = z0 + dz
        wz = torch.clamp(1.0 - torch.abs(ucs - z), min=0.0) * (valid & (z >= 0) & (z < Iu)).to(f)
        row = torch.clamp(z.to(torch.int64), 0, Iu - 1) * Iv
        lo, hi = torch.gather(flat, 1, row + j0), torch.gather(flat, 1, row + j1)
        out = out + wz * (lo + fx * (hi - lo))
    return out * ws


def render(vol: torch.Tensor, affine_inverse: torch.Tensor, pose: torch.Tensor, det: Detector,
           perm, precision: str = "float32") -> torch.Tensor:
    """Shear-warp line integrals (B, H, W) of the bf16 volume ``vol``
    (already in ``perm`` order, (M, Wd, L)) at ``pose`` (B, 4, 4): the
    slope image of :func:`accumulate` resampled at each pixel's slope by
    :func:`warp`."""
    x = slope_setup(affine_inverse, pose, det, perm)
    I = accumulate(vol, x, precision=precision)
    return warp(I, x["uc"], x["vc"], x["ws"]).reshape(pose.shape[0], det.height, det.width)


# ---------------------------------------------------------------------------
# the X-ray and the similarity
# ---------------------------------------------------------------------------


def preprocess_xray(pixels: np.ndarray, crop: int, linearize: bool) -> torch.Tensor:
    """Stored X-ray pixels (H, W) -> (1, 1, H - crop, W - crop) float32:
    centre crop, min-max with a 1e-6 floor, then ``log(max) - log(x + 1)``."""
    img = np.asarray(pixels, np.float32)[None, None]
    if crop:
        H, W = img.shape[-2:]
        top, left = max(crop // 2, 0), max(crop // 2, 0)
        img = img[..., top:top + H - crop, left:left + W - crop]
    img = (img - img.min()) / (img.max() - img.min() + 1e-6)
    if linearize:
        img = img + 1.0
        img = np.log(img.max()) - np.log(img)
    return torch.as_tensor(np.ascontiguousarray(img, dtype=np.float32))


def _resize_weights(n_in: int, n_out: int, dtype, device) -> torch.Tensor:
    """Triangle weights of an antialiased linear resize (kernel widened by
    the downsampling factor, columns normalized, outside samples zeroed)."""
    inv = n_in / n_out
    ks = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=dtype, device=device) + 0.5) * inv - 0.5
    x = torch.abs(sample[None, :] - torch.arange(n_in, dtype=dtype, device=device)[:, None])
    w = torch.clamp(1.0 - x / ks, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def xray_transform(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Per-image min-max, antialiased resize to (height, width), then
    ``(x - 0.15) / 0.1``."""
    dims = tuple(range(1, x.ndim))
    lo, hi = torch.amin(x, dim=dims, keepdim=True), torch.amax(x, dim=dims, keepdim=True)
    x = (x - lo) / (hi - lo + 1e-6)
    if x.shape[-2] != height:
        x = torch.einsum("bchw,ho->bcow", x, _resize_weights(x.shape[-2], height, x.dtype, x.device))
    if x.shape[-1] != width:
        x = torch.einsum("bchw,wo->bcho", x, _resize_weights(x.shape[-1], width, x.dtype, x.device))
    return (x - 0.15) / 0.1


def _global_ncc(x, y):
    mx, my = x.mean(dim=(1, 2, 3), keepdim=True), y.mean(dim=(1, 2, 3), keepdim=True)
    vx = x.var(dim=(1, 2, 3), unbiased=False)
    vy = y.var(dim=(1, 2, 3), unbiased=False)
    cov = ((x - mx) * (y - my)).mean(dim=(1, 2, 3))
    return cov / torch.sqrt(torch.clamp(vx * vy, min=1e-10))


def _local_ncc(x, y, p: int):
    x = x - x.mean(dim=(1, 2, 3), keepdim=True)
    y = y - y.mean(dim=(1, 2, 3), keepdim=True)
    m = F.avg_pool2d(torch.cat([x, y, x * y, x * x, y * y], dim=1), kernel_size=p, stride=1)
    mx, my, mxy, mxx, myy = torch.chunk(m, 5, dim=1)
    vx = torch.clamp(mxx - mx * mx, min=0.0)
    vy = torch.clamp(myy - my * my, min=0.0)
    n = torch.clamp((mxy - mx * my) / torch.sqrt((vx + 1e-6) * (vy + 1e-6)), -1.0, 1.0)
    return n.mean(dim=(1, 2, 3))


def _sobel(x):
    kx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                      dtype=x.dtype, device=x.device) / 8.0
    C = x.shape[1]
    gx = F.conv2d(x, kx.expand(C, 1, 3, 3), padding=1, groups=C)
    gy = F.conv2d(x, kx.T.contiguous().expand(C, 1, 3, 3), padding=1, groups=C)
    return torch.cat([gx, gy], dim=1)


def similarity(x, y, mncc_patch: int = 9, gncc_patch: int = 11, beta: float = 0.5):
    """``beta * (0.5 NCC + 0.5 local NCC) + (1 - beta) * local NCC of Sobel
    gradients`` per image of two (B, 1, H, W) batches -> (B,)."""
    s = beta * (0.5 * _global_ncc(x, y) + 0.5 * _local_ncc(x, y, mncc_patch))
    return s + (1.0 - beta) * _local_ncc(_sobel(x), _sobel(y), gncc_patch)
