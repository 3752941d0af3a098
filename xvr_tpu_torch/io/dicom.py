"""Minimal DICOM reader/writer in pure Python (a copy of the JAX package's
NumPy-only reader, kept here so the port never imports that package).

Covers the X-ray DICOM fields registration consumes: pixel data
(uncompressed), intrinsics (DistanceSourceToDetector, PixelSpacing /
ImagerPixelSpacing, DetectorActiveOrigin), positioner angles, patient
orientation, and multiframe support.

Supports Part-10 files (128-byte preamble + "DICM") and raw datasets, in
explicit and implicit VR little endian, including undefined-length sequences
(skipped). Compressed transfer syntaxes are rejected with a clear error.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

# (group, element) -> name for the tags we expose
TAGS = {
    (0x0002, 0x0010): "TransferSyntaxUID",
    (0x0008, 0x0060): "Modality",
    (0x0018, 0x0050): "SliceThickness",
    (0x0018, 0x0088): "SpacingBetweenSlices",
    (0x0018, 0x1110): "DistanceSourceToDetector",
    (0x0018, 0x1111): "DistanceSourceToPatient",
    (0x0018, 0x1164): "ImagerPixelSpacing",
    (0x0018, 0x1510): "PositionerPrimaryAngle",
    (0x0018, 0x1511): "PositionerSecondaryAngle",
    (0x0018, 0x7026): "DetectorActiveOrigin",
    (0x0020, 0x0020): "PatientOrientation",
    (0x0020, 0x0032): "ImagePositionPatient",
    (0x0020, 0x0037): "ImageOrientationPatient",
    (0x0028, 0x0002): "SamplesPerPixel",
    (0x0028, 0x0004): "PhotometricInterpretation",
    (0x0028, 0x0008): "NumberOfFrames",
    (0x0028, 0x0010): "Rows",
    (0x0028, 0x0011): "Columns",
    (0x0028, 0x0030): "PixelSpacing",
    (0x0028, 0x0100): "BitsAllocated",
    (0x0028, 0x0101): "BitsStored",
    (0x0028, 0x0103): "PixelRepresentation",
    (0x0028, 0x1052): "RescaleIntercept",
    (0x0028, 0x1053): "RescaleSlope",
    (0x7FE0, 0x0010): "PixelData",
}

_EXPLICIT_LONG_VRS = {b"OB", b"OW", b"OF", b"OD", b"OL", b"SQ", b"UC", b"UR", b"UT", b"UN"}
_UNCOMPRESSED = {
    "1.2.840.10008.1.2",        # implicit VR LE
    "1.2.840.10008.1.2.1",      # explicit VR LE
}


class Dataset(dict):
    """Tiny attribute-accessible tag dictionary."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e


def _decode_value(name, vr, raw):
    if name == "PixelData":
        return raw
    if vr in (b"US", b"SS"):
        fmt = "<H" if vr == b"US" else "<h"
        n = len(raw) // 2
        vals = [struct.unpack_from(fmt, raw, 2 * i)[0] for i in range(n)]
        return vals[0] if len(vals) == 1 else vals
    if vr in (b"UL", b"SL"):
        fmt = "<I" if vr == b"UL" else "<i"
        n = len(raw) // 4
        vals = [struct.unpack_from(fmt, raw, 4 * i)[0] for i in range(n)]
        return vals[0] if len(vals) == 1 else vals
    if vr in (b"FL", b"FD"):
        fmt, w = ("<f", 4) if vr == b"FL" else ("<d", 8)
        n = len(raw) // w
        vals = [struct.unpack_from(fmt, raw, w * i)[0] for i in range(n)]
        return vals[0] if len(vals) == 1 else vals
    text = raw.decode("ascii", "ignore").strip("\x00 ").strip()
    if vr in (b"DS", b"IS"):
        parts = [p for p in text.split("\\") if p.strip()]
        conv = float if vr == b"DS" else int
        vals = [conv(p) for p in parts]
        return vals[0] if len(vals) == 1 else vals
    if "\\" in text:
        return [p.strip() for p in text.split("\\")]
    return text


def _parse(raw: bytes, offset: int, explicit: bool, stop_group: int | None = None) -> Dataset:
    ds = Dataset()
    n = len(raw)
    pos = offset
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", raw, pos)
        if stop_group is not None and group > stop_group:
            break
        pos += 4
        # File-meta group (0002) is always explicit VR
        exp = explicit or group == 0x0002
        if exp:
            vr = raw[pos : pos + 2]
            if vr in _EXPLICIT_LONG_VRS:
                length = struct.unpack_from("<I", raw, pos + 4)[0]
                pos += 8
            else:
                length = struct.unpack_from("<H", raw, pos + 2)[0]
                pos += 4
        else:
            vr = b"UN"
            length = struct.unpack_from("<I", raw, pos)[0]
            pos += 4

        if length == 0xFFFFFFFF:
            # Undefined length (sequence / encapsulated data): scan for the
            # sequence delimitation item (FFFE,E0DD)
            end = raw.find(b"\xfe\xff\xdd\xe0", pos)
            if end < 0:
                break
            pos = end + 8
            continue

        value = raw[pos : pos + length]
        pos += length
        name = TAGS.get((group, elem))
        if name:
            if not exp or vr == b"UN":
                vr = _implicit_vr(name)
            ds[name] = _decode_value(name, vr, value)
    return ds


def _implicit_vr(name: str) -> bytes:
    if name in ("Rows", "Columns", "BitsAllocated", "BitsStored",
                "PixelRepresentation", "SamplesPerPixel"):
        return b"US"
    if name in ("DistanceSourceToDetector", "DistanceSourceToPatient",
                "ImagerPixelSpacing", "PixelSpacing", "DetectorActiveOrigin",
                "PositionerPrimaryAngle", "PositionerSecondaryAngle",
                "RescaleIntercept", "RescaleSlope", "SliceThickness",
                "SpacingBetweenSlices", "ImagePositionPatient",
                "ImageOrientationPatient"):
        return b"DS"
    if name == "NumberOfFrames":
        return b"IS"
    if name == "PixelData":
        return b"OW"
    return b"LO"


def dcmread(path: str | Path) -> Dataset:
    raw = Path(path).read_bytes()
    if raw[128:132] == b"DICM":
        meta = _parse(raw, 132, explicit=True, stop_group=0x0002)
        ts = meta.get("TransferSyntaxUID", "1.2.840.10008.1.2.1")
        if ts not in _UNCOMPRESSED:
            raise ValueError(f"Unsupported (compressed) transfer syntax: {ts}")
        explicit = ts != "1.2.840.10008.1.2"
        # find the end of group 0002 to start the main dataset
        ds = _parse(raw, 132, explicit=explicit)
        ds.update(meta)
    else:
        # raw dataset: sniff explicit VR by checking bytes 4:6 for a valid VR
        explicit = raw[4:6].isalpha() and raw[4:6].isupper()
        ds = _parse(raw, 0, explicit=explicit)
    return ds


def pixel_array(ds: Dataset) -> np.ndarray:
    bits = int(ds.get("BitsAllocated", 16))
    signed = int(ds.get("PixelRepresentation", 0)) == 1
    rows, cols = int(ds["Rows"]), int(ds["Columns"])
    frames = int(ds.get("NumberOfFrames", 1) or 1)
    dtype = {8: np.uint8, 16: np.uint16, 32: np.uint32}[bits]
    if signed:
        dtype = {8: np.int8, 16: np.int16, 32: np.int32}[bits]
    data = np.frombuffer(ds["PixelData"], dtype=np.dtype(dtype).newbyteorder("<"),
                         count=rows * cols * frames)
    arr = data.reshape((frames, rows, cols)) if frames > 1 else data.reshape((rows, cols))
    return arr


# ---------------------------------------------------------------------------
# Writer (explicit VR little endian, Part-10) — used by the dataset converter
# ---------------------------------------------------------------------------


def _encode_element(group, elem, vr, value) -> bytes:
    if vr in (b"OB", b"OW"):
        body = value
        if len(body) % 2:
            body += b"\x00"
        # long-form explicit VR: VR + 2 reserved bytes + 4-byte length
        return (
            struct.pack("<HH", group, elem) + vr + b"\x00\x00"
            + struct.pack("<I", len(body)) + body
        )
    if vr == b"US":
        body = struct.pack("<H", int(value))
    elif vr == b"UL":
        body = struct.pack("<I", int(value))
    else:
        if isinstance(value, (list, tuple)):
            text = "\\".join(str(v) for v in value)
        else:
            text = str(value)
        body = text.encode("ascii")
        if len(body) % 2:
            body += b" " if vr != b"UI" else b"\x00"
    return struct.pack("<HH", group, elem) + vr + struct.pack("<H", len(body)) + body


def dcmwrite(
    path: str | Path,
    img: np.ndarray,
    sdd: float,
    row_spacing: float,
    col_spacing: float,
    row_origin: float = 0.0,
    col_origin: float = 0.0,
    extra: dict | None = None,
) -> None:
    """Write a 16-bit MONOCHROME2 X-ray DICOM with projection intrinsics
    (the subset utils/dcmwrite.py:96-115 emits)."""
    img = np.ascontiguousarray(np.asarray(img))
    if img.dtype != np.uint16:
        img = img.astype(np.uint16)
    rows, cols = img.shape[-2:]

    ts = "1.2.840.10008.1.2.1"
    meta = b"".join([
        _encode_element(0x0002, 0x0010, b"UI", ts),
    ])
    elements = [
        (0x0008, 0x0060, b"CS", "RF"),
        (0x0018, 0x1110, b"DS", f"{sdd:g}"),
        (0x0018, 0x7026, b"DS", [f"{row_origin:g}", f"{col_origin:g}"]),
        (0x0028, 0x0002, b"US", 1),
        (0x0028, 0x0004, b"CS", "MONOCHROME2"),
        (0x0028, 0x0010, b"US", rows),
        (0x0028, 0x0011, b"US", cols),
        (0x0028, 0x0030, b"DS", [f"{row_spacing:g}", f"{col_spacing:g}"]),
        (0x0028, 0x0100, b"US", 16),
        (0x0028, 0x0101, b"US", 16),
        (0x0028, 0x0103, b"US", 0),
    ]
    if img.ndim == 3:
        elements.append((0x0028, 0x0008, b"IS", img.shape[0]))
    if extra:
        elements.extend(extra if isinstance(extra, list) else list(extra))
    body = b"".join(_encode_element(*e) for e in sorted(elements))
    body += _encode_element(0x7FE0, 0x0010, b"OW", img.tobytes())

    out = b"\x00" * 128 + b"DICM" + meta + body
    Path(path).write_bytes(out)
