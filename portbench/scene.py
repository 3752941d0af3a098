"""The benchmark's inputs, made on the card from ``--seed``.

Frozen copies, rewritten in PyTorch to run on the card, of the scene that
``chip_smoke.py`` (commit 7233a73) builds for the DeepFluoro workflows:
``build_phantom`` (an ellipsoid body, a rod, a ball and a plate of bone with
a seeded texture, 384 mm across), ``deepfluoro_mask`` (DeepFluoro's seven
labels: 1 soft tissue, 2/3 the rod's halves, 4 the plate, 7 the ball, 5/6 the
"femurs", two lateral boxes of bone), the 60 bone fiducials, the two
``WORKFLOW_POSES`` and ``scripts/chip_mtre_spread.py``'s draw of initial
poses. The files the program reads are written by the small writers below
(uncompressed NIfTI-1, explicit-VR little-endian DICOM), copies of the
port's ``io/nifti.py::save_nifti`` and ``io/dicom.py::dcmwrite``.

Frozen: later changes to the benchmark may add beside this file, not edit it.
"""

from __future__ import annotations

import math
import struct
from pathlib import Path

import numpy as np
import torch

from . import reference as ref

# the two X-ray views of chip_smoke.py's DeepFluoro subject (ZXY degrees, mm)
WORKFLOW_POSES = (((182.0, -4.0, 3.0), (6.0, 740.0, -10.0)),
                  ((176.5, 2.0, -2.5), (-8.0, 760.0, 6.0)))


def _gauss_taps(sigma: float, device) -> torch.Tensor:
    radius = int(4.0 * sigma + 0.5)
    t = torch.arange(-radius, radius + 1, dtype=torch.float64, device=device)
    w = torch.exp(-0.5 * (t / sigma) ** 2)
    return (w / w.sum()).to(torch.float32)


def gaussian_filter(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of a 3D volume (taps to 4 sigma, edges
    repeated), as sums of shifted copies: deterministic, no TF32."""
    w = _gauss_taps(sigma, x.device)
    r = (w.numel() - 1) // 2
    for axis in range(3):
        n = x.shape[axis]
        lo = x.narrow(axis, 0, 1).expand(*[r if a == axis else s for a, s in enumerate(x.shape)])
        hi = x.narrow(axis, n - 1, 1).expand(*[r if a == axis else s for a, s in enumerate(x.shape)])
        xp = torch.cat([lo, x, hi], dim=axis)
        out = torch.zeros_like(x)
        for t in range(w.numel()):
            out.add_(xp.narrow(axis, t, n), alpha=float(w[t]))
        x = out
        del xp
    return x


def build_ct(n: int, seed: int, device, fiducial_seed: int | None = None):
    """-> (hu (n, n, n) int16 on ``device``, affine (4, 4) float64, 60 bone
    fiducials (60, 3) world mm, float64). 384 mm across, centred at the
    origin; the texture is drawn from ``seed``, the fiducials from
    ``fiducial_seed`` (by default ``seed``)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    f = torch.float32
    sp = 384.0 / n
    c = (n - 1) / 2
    idx = torch.arange(n, dtype=f, device=device)
    X, Y, Z = idx[:, None, None], idx[None, :, None], idx[None, None, :]
    body = ((X - c) / (0.45 * n)) ** 2 + ((Y - c) / (0.30 * n)) ** 2 + ((Z - c) / (0.40 * n)) ** 2
    hu = torch.where(body <= 1.0, 40.0, -1000.0).to(f)
    del body
    A = (0.0, 0.35 * n, 0.9 * n)
    D = (float(n), 0.3 * n, -0.8 * n)
    DD = sum(d * d for d in D)
    tstar = torch.clamp(((X - A[0]) * D[0] + (Y - A[1]) * D[1] + (Z - A[2]) * D[2]) / DD, 0.28, 0.72)
    r2 = (X - A[0] - tstar * D[0]) ** 2 + (Y - A[1] - tstar * D[1]) ** 2 + (Z - A[2] - tstar * D[2]) ** 2
    hu = torch.where(r2 <= (0.045 * n) ** 2, 1200.0, hu)
    del tstar
    r2 = (X - 0.62 * n) ** 2 + (Y - 0.45 * n) ** 2 + (Z - 0.6 * n) ** 2
    hu = torch.where(r2 <= (0.10 * n) ** 2, torch.clamp(hu, min=1000.0), hu)
    plate = (torch.abs(X - 0.35 * n) < 0.04 * n) & (torch.abs(Y - 0.55 * n) < 0.12 * n) & (
        torch.abs(Z - 0.35 * n) < 0.12 * n)
    hu = torch.where(plate, torch.clamp(hu, min=1400.0), hu)
    del r2, plate
    hu = gaussian_filter(hu, 2.0 * n / 256)
    tex = gaussian_filter(torch.randn((n, n, n), generator=gen, device=device, dtype=f), 1.2 * n / 256)
    tex *= 250.0 / max(float(tex.std(correction=0)), 1e-6)
    hu = torch.where(hu > 400.0, hu + tex, hu)
    del tex
    hu = torch.clamp(torch.round(hu), -32768, 32767).to(torch.int16)
    aff = np.eye(4) * sp
    aff[3, 3] = 1.0
    aff[:3, 3] = -c * sp
    bone = torch.nonzero(hu > 600)
    if fiducial_seed is not None:
        gen = torch.Generator(device=device).manual_seed(int(fiducial_seed))
    pick = torch.randperm(bone.shape[0], generator=gen, device=device)[:60]
    fids = bone[pick].double().cpu().numpy() * sp - c * sp
    return hu, aff, fids


def deepfluoro_mask(hu: torch.Tensor) -> torch.Tensor:
    """DeepFluoro's labels on the phantom -> uint8 labelmap on hu's device."""
    n = hu.shape[0]
    idx = torch.arange(n, dtype=torch.float32, device=hu.device)
    X, Y, Z = idx[:, None, None], idx[None, :, None], idx[None, None, :]
    bone = hu > 600
    mask = (hu > -500).to(torch.uint8)
    mask = torch.where(bone & (Z < (n - 1) / 2), 2, mask)
    mask = torch.where(bone & (Z >= (n - 1) / 2), 3, mask)
    plate = (torch.abs(X - 0.35 * n) < 0.04 * n) & (torch.abs(Y - 0.55 * n) < 0.12 * n) & (
        torch.abs(Z - 0.35 * n) < 0.12 * n)
    mask = torch.where(bone & plate, 4, mask)
    ball = (X - 0.62 * n) ** 2 + (Y - 0.45 * n) ** 2 + (Z - 0.6 * n) ** 2 <= (0.1 * n) ** 2
    mask = torch.where(bone & ball, 7, mask)
    mask = torch.where(bone & (X < 0.32 * n) & (Z > 0.55 * n), 5, mask)
    mask = torch.where(bone & (X > 0.69 * n), 6, mask)
    return mask.to(torch.uint8)


def draw_views(rng: np.random.Generator, n: int, rot_deg: float, xyz_mm: float):
    """``n`` ground-truth views about the WORKFLOW_POSES in turn, each moved
    by up to ``rot_deg`` per ZXY angle and ``xyz_mm`` per axis. -> (rot
    radians (n, 3), xyz mm (n, 3)), float64."""
    base_r = np.array([WORKFLOW_POSES[i % 2][0] for i in range(n)], np.float64)
    base_t = np.array([WORKFLOW_POSES[i % 2][1] for i in range(n)], np.float64)
    rot = np.deg2rad(base_r + rng.uniform(-rot_deg, rot_deg, (n, 3)))
    return rot, base_t + rng.uniform(-xyz_mm, xyz_mm, (n, 3))


def draw_init(rng: np.random.Generator, rot: np.ndarray, xyz: np.ndarray, rot_deg: float,
              xyz_mm: float):
    """scripts/chip_mtre_spread.py's draw about a view: each ZXY angle moved
    by up to ``rot_deg`` degrees, each axis by up to ``xyz_mm``."""
    return (rot + np.deg2rad(rng.uniform(-rot_deg, rot_deg, 3)),
            xyz + rng.uniform(-xyz_mm, xyz_mm, 3))


def poses(rot, xyz, device) -> torch.Tensor:
    """float64 parameters -> (B, 4, 4) float32 matrices on ``device``."""
    r = torch.as_tensor(np.atleast_2d(rot), dtype=torch.float64, device=device)
    t = torch.as_tensor(np.atleast_2d(xyz), dtype=torch.float64, device=device)
    return ref.pose_zxy(r, t).to(torch.float32)


def xray_pixels(density_perm: torch.Tensor, affine_inverse: torch.Tensor, pose: torch.Tensor,
                det: ref.Detector, perm) -> np.ndarray:
    """The plain render of one view, stored as the intensity
    ``2 exp(-ln 2 d / max d) - 1`` that ``--linearize`` maps back to the line
    integral d, scaled to 16 bits. -> (H, W) uint16."""
    d = ref.render(density_perm, affine_inverse, pose, det, perm)[0].double()
    intensity = 2.0 * torch.exp(-math.log(2.0) * d / d.max()) - 1.0
    return torch.round(intensity * 60000).to(torch.int32).cpu().numpy().astype(np.uint16)


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------

_NIFTI_CODES = {np.dtype(np.uint8): 2, np.dtype(np.int16): 4, np.dtype(np.float32): 16}


def write_nifti(path: Path, data: np.ndarray, affine: np.ndarray) -> None:
    """Uncompressed single-file NIfTI-1 with an sform affine."""
    data = np.asarray(data)
    code = _NIFTI_CODES[data.dtype]
    spacing = np.linalg.norm(affine[:3, :3], axis=0)
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, *data.shape, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1.0, *spacing, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<f", hdr, 112, 1.0)
    struct.pack_into("<h", hdr, 254, 1)
    struct.pack_into("<12f", hdr, 280, *np.asarray(affine, np.float64)[:3].reshape(-1))
    hdr[344:348] = b"n+1\x00"
    with open(path, "wb") as f:
        f.write(bytes(hdr) + b"\x00" * 4)
        f.write(np.asfortranarray(data).tobytes(order="F"))


def _element(group, elem, vr, value) -> bytes:
    if vr == b"OW":
        return struct.pack("<HH", group, elem) + vr + b"\x00\x00" + struct.pack("<I", len(value)) + value
    if vr == b"US":
        body = struct.pack("<H", int(value))
    else:
        text = "\\".join(str(v) for v in value) if isinstance(value, (list, tuple)) else str(value)
        body = text.encode("ascii")
        if len(body) % 2:
            body += b" " if vr != b"UI" else b"\x00"
    return struct.pack("<HH", group, elem) + vr + struct.pack("<H", len(body)) + body


def write_dicom(path: Path, img: np.ndarray, sdd: float, spacing: float) -> None:
    """A 16-bit MONOCHROME2 X-ray with its projection intrinsics."""
    rows, cols = img.shape
    meta = _element(0x0002, 0x0010, b"UI", "1.2.840.10008.1.2.1")
    elements = [
        (0x0008, 0x0060, b"CS", "RF"),
        (0x0018, 0x1110, b"DS", f"{sdd:g}"),
        (0x0018, 0x7026, b"DS", ["0", "0"]),
        (0x0028, 0x0002, b"US", 1),
        (0x0028, 0x0004, b"CS", "MONOCHROME2"),
        (0x0028, 0x0010, b"US", rows),
        (0x0028, 0x0011, b"US", cols),
        (0x0028, 0x0030, b"DS", [f"{spacing:g}", f"{spacing:g}"]),
        (0x0028, 0x0100, b"US", 16),
        (0x0028, 0x0101, b"US", 16),
        (0x0028, 0x0103, b"US", 0),
    ]
    body = b"".join(_element(*e) for e in elements)
    body += _element(0x7FE0, 0x0010, b"OW", np.ascontiguousarray(img, dtype="<u2").tobytes())
    Path(path).write_bytes(b"\x00" * 128 + b"DICM" + meta + body)
