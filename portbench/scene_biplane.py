"""The biplane cell's inputs, made from its seeds: an unmasked 3D-DSA-like
head volume, its fiducials and the pool of frontal and lateral views.

The volume is a seeded tree of contrast-filled vessels in air, as a
subtracted cerebral angiogram holds contrast alone: a few roots enter from
below (two carotid-like trunks of 2.5 mm radius and a basilar-like one of
2 mm) and climb, each a chain of straight pieces whose direction drifts;
every branch splits in two at its end, the children's radii 0.70-0.85 of
their parent's, until a radius falls under 0.4 mm. A branch that leaves the
head's sphere is turned back into it. Each vessel is a tube of about +500 HU
(its own draw of 450-550 HU) with a one-voxel antialiased wall, drawn into a
background of -1000 HU, which the port's HU transform maps to zero density.
The tree is laid out in millimetres, whatever the grid: a coarser grid
widens every vessel to at least one voxel's radius.

The 60 fiducials are points on the vessels' centrelines (the middles of the
tree's pieces), picked by their own seed. The pool's views are ``pool / 2``
frontal C-arm views about r1 = 0 degrees (the beam along the volume's second
axis) and as many lateral ones about r1 = 90 degrees (along its first), each
drawn within the published training ranges of the Ljubljana finetune
(``scripts/ljubljana/train/finetune.sh``): r1 within ``r1`` degrees of its
view, r2 and r3 within ``r23``, tx and tz within ``txz`` mm, ty in ``ty``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EXTENT_MM = 204.8  # a head: 512 voxels of 0.4 mm
HEAD_RADIUS = 0.42  # of the extent
ROOTS = ((-22.0, 8.0, 2.5), (22.0, 8.0, 2.5), (0.0, -18.0, 2.0))  # x, y mm at the bottom, radius mm
MIN_RADIUS_MM = 0.4
CONTRAST_HU = (450.0, 550.0)
AIR_HU = -1000.0


def vessel_tree(seed: int) -> list:
    """The tree's straight pieces, (a (3,), b (3,), radius mm, contrast HU),
    in world mm about the volume's centre, drawn from ``seed``."""
    rng = np.random.default_rng(int(seed))
    head = HEAD_RADIUS * EXTENT_MM
    pieces = []
    todo = []
    for x, y, r in ROOTS:
        start = np.array([x, y, -0.46 * EXTENT_MM])
        todo.append((start, np.array([0.0, 0.0, 1.0]), r, rng.uniform(*CONTRAST_HU)))
    while todo:
        p, d, r, hu = todo.pop()
        length = rng.uniform(14.0, 22.0) * r ** 0.8 + 6.0
        n = max(int(math.ceil(length / max(2.5 * r, 3.0))), 2)
        step = length / n
        for _ in range(n):
            d = d + rng.normal(0.0, 0.22, 3)
            inward = -p / max(np.linalg.norm(p), 1e-6)
            if np.linalg.norm(p) > head - 2.0 * r:  # turned back into the head
                d = d + 1.5 * inward
            d = d / np.linalg.norm(d)
            q = p + step * d
            pieces.append((p, q, r, hu))
            p = q
        for sign in (1.0, -1.0):
            rc = r * rng.uniform(0.70, 0.85)
            if rc < MIN_RADIUS_MM:
                continue
            axis = np.cross(d, rng.normal(0.0, 1.0, 3))
            axis /= max(np.linalg.norm(axis), 1e-9)
            ang = sign * math.radians(rng.uniform(25.0, 50.0))
            dc = d * math.cos(ang) + np.cross(axis, d) * math.sin(ang)
            todo.append((p, dc / np.linalg.norm(dc), rc, hu + rng.uniform(-20.0, 20.0)))
    return pieces


def build_vessels(n: int, seed: int, device, fiducial_seed: int | None = None):
    """-> (hu (n, n, n) int16 on ``device``, affine (4, 4) float64, 60
    centreline fiducials (60, 3) world mm, float64). ``EXTENT_MM`` across,
    centred at the origin; the tree is drawn from ``seed``, the fiducials
    from ``fiducial_seed`` (by default ``seed``)."""
    sp = EXTENT_MM / n
    c = (n - 1) / 2
    f = torch.float32
    fill = torch.zeros((n, n, n), dtype=f, device=device)  # HU above air
    idx = torch.arange(n, dtype=f, device=device)
    pieces = vessel_tree(seed)
    for a, b, r, hu in pieces:
        av, bv = a / sp + c, b / sp + c  # voxel coordinates
        rv = max(r / sp, 1.0)
        lo = np.maximum(np.floor(np.minimum(av, bv) - rv - 1.0), 0).astype(int)
        hi = np.minimum(np.ceil(np.maximum(av, bv) + rv + 2.0), n).astype(int)
        if (hi <= lo).any():
            continue
        X = idx[lo[0]:hi[0], None, None] - float(av[0])
        Y = idx[None, lo[1]:hi[1], None] - float(av[1])
        Z = idx[None, None, lo[2]:hi[2]] - float(av[2])
        dv = bv - av
        dd = float(dv @ dv)
        t = torch.clamp((X * float(dv[0]) + Y * float(dv[1]) + Z * float(dv[2])) / max(dd, 1e-12),
                        0.0, 1.0)
        dist = torch.sqrt((X - t * float(dv[0])) ** 2 + (Y - t * float(dv[1])) ** 2
                          + (Z - t * float(dv[2])) ** 2)
        val = torch.clamp(rv + 0.5 - dist, 0.0, 1.0) * float(hu - AIR_HU)
        box = fill[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        torch.maximum(box, val, out=box)
    hu = torch.round(fill + AIR_HU).to(torch.int16)
    aff = np.eye(4) * sp
    aff[3, 3] = 1.0
    aff[:3, 3] = -c * sp
    mids = np.array([(a + b) / 2 for a, b, _, _ in pieces], np.float64)
    pick = np.random.default_rng(int(seed if fiducial_seed is None else fiducial_seed)).choice(
        len(mids), 60, replace=False)
    return hu, aff, mids[np.sort(pick)]


def draw_views(rng: np.random.Generator, n: int, views: dict):
    """``n`` ground-truth views, the first half frontal (about r1 =
    ``views["frontal"]``), the rest lateral (about ``views["lateral"]``),
    drawn within the mix's ranges. -> (rot radians (n, 3), xyz mm (n, 3)),
    float64."""
    base = np.array([views["frontal"]] * (n // 2) + [views["lateral"]] * (n - n // 2), np.float64)
    r1 = base + rng.uniform(-views["r1"], views["r1"], n)
    r23 = rng.uniform(-views["r23"], views["r23"], (n, 2))
    rot = np.deg2rad(np.column_stack([r1, r23]))
    txz = rng.uniform(-views["txz"], views["txz"], (n, 2))
    ty = rng.uniform(*views["ty"], n)
    return rot, np.column_stack([txz[:, 0], ty, txz[:, 1]])
