"""Minimal NIfTI-1 reader/writer in pure NumPy (a copy of the JAX package's
NumPy-only loader, kept here so the port never imports that package).

Supports: NIfTI-1 single-file (.nii / .nii.gz), little/big endian, the common
datatypes, scl_slope/scl_inter intensity scaling, sform/qform affines, and
canonical (closest-to-RAS) reorientation.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _quaternion_to_affine(hdr) -> np.ndarray:
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a = np.sqrt(max(0.0, 1.0 - (b * b + c * c + d * d)))
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    qfac = 1.0 if hdr["pixdim"][0] >= 0 else -1.0
    spacing = np.array([hdr["pixdim"][1], hdr["pixdim"][2], qfac * hdr["pixdim"][3]])
    A = np.eye(4)
    A[:3, :3] = R * spacing
    A[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return A


def _read_header(raw: bytes):
    sizeof_hdr = struct.unpack("<i", raw[:4])[0]
    endian = "<" if sizeof_hdr == 348 else ">"
    if struct.unpack(endian + "i", raw[:4])[0] != 348:
        raise ValueError("Not a NIfTI-1 file (bad sizeof_hdr)")
    h = {}
    h["endian"] = endian
    h["dim"] = struct.unpack(endian + "8h", raw[40:56])
    h["datatype"] = struct.unpack(endian + "h", raw[70:72])[0]
    h["bitpix"] = struct.unpack(endian + "h", raw[72:74])[0]
    h["pixdim"] = struct.unpack(endian + "8f", raw[76:108])
    h["vox_offset"] = struct.unpack(endian + "f", raw[108:112])[0]
    h["scl_slope"] = struct.unpack(endian + "f", raw[112:116])[0]
    h["scl_inter"] = struct.unpack(endian + "f", raw[116:120])[0]
    h["qform_code"] = struct.unpack(endian + "h", raw[252:254])[0]
    h["sform_code"] = struct.unpack(endian + "h", raw[254:256])[0]
    (h["quatern_b"], h["quatern_c"], h["quatern_d"],
     h["qoffset_x"], h["qoffset_y"], h["qoffset_z"]) = struct.unpack(endian + "6f", raw[256:280])
    h["srow"] = np.array(struct.unpack(endian + "12f", raw[280:328])).reshape(3, 4)
    h["magic"] = raw[344:348]
    return h


def load_nifti(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """-> (data[nx, ny, nz], affine[4, 4] voxel->world mm)."""
    path = Path(path)
    opener = gzip.open if path.name.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    hdr = _read_header(raw[:352])
    ndim = hdr["dim"][0]
    shape = tuple(hdr["dim"][1 : 1 + max(ndim, 3)])
    shape = tuple(max(s, 1) for s in shape[:3])
    dtype = np.dtype(_DTYPES[hdr["datatype"]]).newbyteorder(hdr["endian"])
    offset = int(hdr["vox_offset"])
    n = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=n, offset=offset)
    data = data.reshape(shape, order="F").astype(np.float32)
    slope, inter = hdr["scl_slope"], hdr["scl_inter"]
    if slope not in (0.0, 1.0) or inter != 0.0:
        if slope == 0.0:
            slope = 1.0
        data = data * slope + inter
    if hdr["sform_code"] > 0:
        affine = np.eye(4)
        affine[:3] = hdr["srow"]
    elif hdr["qform_code"] > 0:
        affine = _quaternion_to_affine(hdr)
    else:
        affine = np.diag([hdr["pixdim"][1], hdr["pixdim"][2], hdr["pixdim"][3], 1.0])
    return data, affine.astype(np.float64)


def save_nifti(path: str | Path, data: np.ndarray, affine: np.ndarray) -> None:
    """Write a single-file NIfTI-1 (.nii or .nii.gz) with an sform affine."""
    path = Path(path)
    data = np.asarray(data)
    affine = np.asarray(affine, dtype=np.float64)
    if data.ndim != 3:
        raise ValueError("save_nifti expects a 3D array")
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    code = _DTYPE_CODES[np.dtype(data.dtype)]
    spacing = np.linalg.norm(affine[:3, :3], axis=0)

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, *data.shape, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1.0, *spacing, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<12f", hdr, 280, *affine[:3].reshape(-1))
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00\x00\x00\x00" + data.tobytes(order="F")
    opener = gzip.open if path.name.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)


def to_canonical(data: np.ndarray, affine: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Reorient to the closest-to-RAS axis ordering (torchio ToCanonical
    semantics: axis permutation + flips only, no resampling)."""
    R = affine[:3, :3]
    # For each world axis, find the voxel axis with the largest |direction|
    perm = [-1, -1, -1]
    used = set()
    order = np.argsort(-np.abs(R), axis=None)
    for flat in order:
        world, vox = divmod(int(flat), 3)
        if perm[world] == -1 and vox not in used:
            perm[world] = vox
            used.add(vox)
    flips = [R[w, perm[w]] < 0 for w in range(3)]

    data = np.transpose(data, perm)
    new_affine = np.eye(4)
    new_affine[:3, :3] = affine[:3, perm]
    new_affine[:3, 3] = affine[:3, 3]
    for w in range(3):
        if flips[w]:
            data = np.flip(data, axis=w)
            n = data.shape[w]
            new_affine[:3, 3] = new_affine[:3, 3] + new_affine[:3, w] * (n - 1)
            new_affine[:3, w] = -new_affine[:3, w]
    return np.ascontiguousarray(data), new_affine
