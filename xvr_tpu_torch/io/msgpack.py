"""The subset of MessagePack that flax checkpoints use, in pure Python.

The JAX package writes its checkpoints with ``flax.serialization``
(``msgpack_serialize``): a tree of maps whose leaves are ints, floats,
strings, bytes, bools, None, and arrays. An array travels as extension type
1, whose payload is itself a packed ``(shape, dtype name, C-order bytes)``;
a NumPy scalar as extension type 3 with the same payload for a 0-d array.
An array larger than ``MAX_CHUNK_SIZE`` bytes is split into a chunked-array
map (``__msgpack_chunked_array__``). This module reads and writes that
format without ``msgpack`` or ``flax``, byte for byte as they do.

Arrays decode to NumPy arrays, except ``bfloat16``, which NumPy lacks: it
decodes to a ``torch.bfloat16`` tensor (exact), and a ``torch`` tensor of
any dtype encodes as the array it holds.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # bytes; flax.serialization's chunking threshold
EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -0x20 <= n < 0:
        out += struct.pack("b", n)
    elif n >= 0:
        for code, fmt, hi in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                              (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if n <= hi:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"int too large for msgpack: {n}")
    else:
        for code, fmt, lo in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                              (0xD2, ">i", -(2**31)), (0xD3, ">q", -(2**63))):
            if n >= lo:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"int too small for msgpack: {n}")


def _pack_len(n: int, codes, out: bytearray, fix_code: int | None = None, fix_max: int = 0):
    """A length header: the fix form below ``fix_max``, else the first of
    ``codes`` (code, format, largest length) that holds ``n``."""
    if fix_code is not None and n < fix_max:
        out.append(fix_code | n)
        return
    for code, fmt, hi in codes:
        if n <= hi:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"object too large for msgpack: {n}")


_STR = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_BIN = ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF))
_ARRAY = ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP = ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF), (0xC9, ">I", 0xFFFFFFFF))


def _array_payload(shape, dtype_name: str, data: bytes) -> bytes:
    return packb([list(shape), dtype_name, data])


def _tensor_payload(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return _array_payload(t.shape, "bfloat16", t.view(torch.int16).numpy().tobytes())
    return _ndarray_payload(t.numpy())


def _ndarray_payload(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be packed")
    return _array_payload(a.shape, a.dtype.name, a.tobytes("C"))


def _pack_ext(code: int, payload: bytes, out: bytearray) -> None:
    n = len(payload)
    if n in _FIXEXT:
        out.append(_FIXEXT[n])
    else:
        _pack_len(n, _EXT, out)
    out.append(code)
    out += payload


def _pack(obj, out: bytearray) -> None:
    # exact types, as msgpack's strict_types packing (flax) requires
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        _pack_len(len(raw), _STR, out, 0xA0, 32)
        out += raw
    elif type(obj) in (bytes, bytearray):
        _pack_len(len(obj), _BIN, out)
        out += obj
    elif type(obj) in (list, tuple):
        _pack_len(len(obj), _ARRAY, out, 0x90, 16)
        for v in obj:
            _pack(v, out)
    elif type(obj) is dict:
        _pack_len(len(obj), _MAP, out, 0x80, 16)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    elif isinstance(obj, torch.Tensor):
        _pack_ext(EXT_NDARRAY, _tensor_payload(obj), out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    """Pack a tree of dict/list/tuple/str/bytes/int/float/bool/None with
    NumPy array, NumPy scalar and torch tensor leaves (no chunking)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _chunk_leaves(tree):
    """Split array leaves above MAX_CHUNK_SIZE bytes into flax's chunked
    maps (``_chunk_array_leaves_in_place``), in a copy of the tree."""
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) for k, v in tree.items()}
    nbytes = (tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor)
              else tree.nbytes if isinstance(tree, np.ndarray) else 0)
    if nbytes <= MAX_CHUNK_SIZE:
        return tree
    itemsize = tree.element_size() if isinstance(tree, torch.Tensor) else tree.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = tree.reshape(-1)
    chunks = [flat[i : i + size] for i in range(0, flat.shape[0], size)]
    return {
        CHUNKED: True,
        "shape": {str(i): int(s) for i, s in enumerate(tree.shape)},
        "chunks": {str(i): c for i, c in enumerate(chunks)},
    }


def serialize(tree) -> bytes:
    """``flax.serialization.msgpack_serialize`` of a tree of dicts."""
    return packb(_chunk_leaves(tree))


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def _array_from_payload(payload: bytes):
    shape, name, data = unpackb(payload, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        t = torch.frombuffer(bytearray(data), dtype=torch.bfloat16) if data else \
            torch.empty(0, dtype=torch.bfloat16)
        return t.reshape(tuple(shape))
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(tuple(shape), order="C").copy()


_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i",
            0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
# type byte -> (kind, format of its length)
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"), 0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}
_FIXEXT_LEN = {code: n for n, code in _FIXEXT.items()}


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = bytes(self.data[self.pos : self.pos + n])
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def text(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from_payload(payload)
        if code == EXT_NPSCALAR:
            a = _array_from_payload(payload)
            return a.reshape(()) if isinstance(a, torch.Tensor) else a[()]
        raise ValueError(f"unsupported msgpack extension type {code}")

    def read(self):
        c = self.unpack(">B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.read() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.text(c & 0x1F)
        if c in _SIMPLE:
            return _SIMPLE[c]
        if c in _NUMBERS:
            return self.unpack(_NUMBERS[c])
        if c in _FIXEXT_LEN:
            return self.ext(_FIXEXT_LEN[c])
        if c not in _SIZED:
            raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")
        kind, fmt = _SIZED[c]
        n = self.unpack(fmt)
        if kind == "bin":
            return self.take(n)
        if kind == "str":
            return self.text(n)
        if kind == "array":
            return [self.read() for _ in range(n)]
        if kind == "map":
            return self.map(n)
        return self.ext(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data: bytes, raw: bool = False):
    """Unpack one object; ``raw`` leaves strings as bytes."""
    reader = _Reader(data, raw)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("extra data after the msgpack object")
    return obj


def _unchunk_leaves(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk_leaves(v) for k, v in tree.items()}
    return tree


def restore(data: bytes):
    """``flax.serialization.msgpack_restore``: the tree, chunked arrays joined."""
    return _unchunk_leaves(unpackb(data))
