"""Build, load and launch the hand-written CUDA kernels (shear-warp K1-K4,
slab march K5-K8, and the rays' pose adjoint).

The sources live in ``xvr_tpu_torch/csrc/`` (``MANIFEST.in`` ships them in
the package). On first use each source is compiled by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface, keyed by a hash of the sources and flags,
that is loaded with ``ctypes``. It goes to :func:`build_dir`:
``$XVR_TORCH_BUILD_DIR`` when set, else ``build/`` at the repository root
when that can be written, else ``~/.cache/xvr_tpu_torch/build``.
``slab.cu`` is compiled with ``-fmad=false`` (see the note at its top).
Nothing here runs at import time, so the module imports on a machine without
a GPU or ``nvcc``.

Each launch function checks device, dtype, shape and contiguity, allocates
its outputs with ``torch.empty``, launches on the current CUDA stream,
raises if the library reports a CUDA error, and adds one to its entry in
:data:`LAUNCHES`. Launches made while a CUDA graph is captured are taken
back out (:func:`captured`) and added at each replay (:func:`replayed`), so
the counts are of kernels run.

K1 and K4 also count on the device: each block adds the slabs it marched and
those it skipped for their content (:func:`content_boxes`) to a per-device
buffer at a fixed address (:func:`slab_tally`), so a replayed graph counts
too. :mod:`~xvr_tpu_torch.utils.profiling` zeroes the buffers when tracing
turns on and reads them in its snapshot (:func:`zero_tallies`,
:func:`read_tallies`), as the counters ``shearwarp.slabs_marched`` and
``shearwarp.slabs_skipped``. The module imports nothing of the package, so
a script can load another checkout's copy of it on its own.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (CSRC / "shearwarp.cu", CSRC / "slab.cu", CSRC / "rays.cu")
# per-source nvcc flags beyond the common ones
SOURCE_FLAGS = {"slab.cu": ("-fmad=false",)}
BUILD_ENV = "XVR_TORCH_BUILD_DIR"
REPO_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

# launches per kernel since the last reset_launches(); read by chip_smoke.py
# to show that a run went through the kernels
LAUNCHES = {
    "sw_accumulate": 0, "sw_warp": 0, "sw_warp_grads": 0, "sw_accumulate_adjoint": 0,
    "slab_forward": 0, "slab_backward": 0, "slab_channels": 0, "slab_siddon": 0,
    "rays_adjoint": 0, "sw_content_boxes": 0,
}

_lib = None
BUILD_INFO: dict = {}
# device -> (2,) int64 on it: K1/K4 slabs marched, skipped for their content
_TALLY: dict = {}
TALLY_NAMES = ("shearwarp.slabs_marched", "shearwarp.slabs_skipped")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def captured():
    """Around a CUDA graph's capture: the launches counted inside were
    recorded, not run. They are taken back out of :data:`LAUNCHES` on exit
    and left in the yielded dict (kernel -> launches) for :func:`replayed`."""
    before, taken = dict(LAUNCHES), {}
    try:
        yield taken
    finally:
        for k, n in LAUNCHES.items():
            if n > before[k]:
                taken[k] = n - before[k]
                LAUNCHES[k] = before[k]


def replayed(launches: dict) -> None:
    """Count one replay of a graph whose capture launched ``launches``."""
    for k, n in launches.items():
        LAUNCHES[k] += n


def slab_tally(device) -> torch.Tensor:
    """The (2,) int64 buffer on ``device`` that K1 and K4 add their slab
    counts to (marched, skipped for content), made on first use, outside a
    graph's capture, and kept at its address."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    buf = _TALLY.get(device)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the slab tally is made by a launch outside a CUDA graph's capture")
        buf = _TALLY[device] = torch.zeros(2, dtype=torch.int64, device=device)
    return buf


def zero_tallies() -> None:
    """Zero every device's slab tally on its current stream (no sync)."""
    for dev, buf in _TALLY.items():
        with torch.cuda.device(dev):
            buf.zero_()


def read_tallies() -> dict:
    """The slab tallies summed over the devices, read on the host (which
    waits for each device), by :data:`TALLY_NAMES`; {} before any."""
    if not _TALLY:
        return {}
    total = [0, 0]
    for buf in _TALLY.values():
        for i, n in enumerate(buf.tolist()):
            total[i] += n
    return dict(zip(TALLY_NAMES, total))


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _writable(path: Path) -> bool:
    """Whether ``path`` can be written, or made where it does not exist yet."""
    while not path.exists():
        if path.parent == path:
            return False
        path = path.parent
    return path.is_dir() and os.access(path, os.W_OK | os.X_OK)


def build_dir() -> Path:
    """Where the kernels are built: ``$XVR_TORCH_BUILD_DIR`` when it is set,
    else the repository's ``build/`` when it can be written (a checkout),
    else the user cache (an installed package)."""
    if os.environ.get(BUILD_ENV):
        return Path(os.environ[BUILD_ENV])
    if _writable(REPO_BUILD_DIR):
        return REPO_BUILD_DIR
    return Path.home() / ".cache" / "xvr_tpu_torch" / "build"


def build(verbose: bool = False) -> Path:
    """Compile the kernel sources into :func:`build_dir` unless an
    up-to-date library is there already; returns its path. One ``nvcc -c``
    per source runs in parallel, then one link. ``verbose`` adds ``-Xptxas
    -v`` and keeps the compilers' report in ``BUILD_INFO``."""
    common = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    key = repr((common, SOURCE_FLAGS)).encode() + b"".join(p.read_bytes() for p in SOURCES)
    digest = hashlib.sha256(key).hexdigest()[:12]
    where = build_dir()
    out = where / f"libxvr_kernels_{digest}.so"
    if out.exists() and not verbose:
        BUILD_INFO.update(path=str(out), seconds=0.0, log="(cached)")
        return out
    where.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{digest}.{os.getpid()}"
    t0 = time.perf_counter()
    procs = []
    for src in SOURCES:
        obj = where / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *common, *SOURCE_FLAGS.get(src.name, ()), "-c", "-o", str(obj), str(src)]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, proc in procs:
        text = proc.communicate()[0]
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name} ({proc.returncode}):\n{text}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in procs)]
    res = subprocess.run(link, capture_output=True, text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0,
                      log="".join(logs) + res.stdout + res.stderr)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sw_accumulate.argtypes = [P, I, I, P, P, P, I, I, I, F, I, I, P, P]
    lib.sw_content_boxes.argtypes = [P, I, I, I, P, P]
    lib.sw_warp.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
    lib.sw_warp_grads.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, P]
    lib.sw_adjoint_partials_shape.argtypes = [I, I, ctypes.POINTER(I), ctypes.POINTER(I)]
    lib.sw_accumulate_adjoint.argtypes = [P, I, I, P, P, P, P, P, P, P, I, I, I, F, I, I, P, P]
    lib.slab_forward.argtypes = [P, I, I, I, P, P, I, I, P]
    lib.slab_backward.argtypes = [P, I, I, I, P, P, P, I, I, P]
    lib.slab_plane_split.argtypes = [I, I]
    lib.slab_max_channels.argtypes = []
    lib.slab_channels.argtypes = [P, P, I, I, I, ctypes.POINTER(I), I, P, P, I, I, P]
    lib.slab_siddon.argtypes = [P, I, I, I, P, P, I, I, P]
    lib.rays_adjoint_blocks.argtypes = [I]
    lib.rays_adjoint.argtypes = [P, P, P, P, I, I, I, P]
    for fn in ("sw_accumulate", "sw_content_boxes", "sw_warp", "sw_warp_grads",
               "sw_adjoint_partials_shape", "sw_accumulate_adjoint", "slab_forward",
               "slab_backward", "slab_plane_split", "slab_max_channels", "slab_channels",
               "slab_siddon", "rays_adjoint_blocks", "rays_adjoint"):
        getattr(lib, fn).restype = I
    _lib = lib
    return lib


def _check(x: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def content_boxes(vol) -> torch.Tensor:
    """The content boxes of ``vol`` (M, Wd, L) or a stack (C, M, Wd, L),
    bf16 -> (C, M, 4) int32 (C = 1 for a volume): per slab, the first and
    last row and lane holding a nonzero value, (Wd, -1, L, -1) for a slab
    of zeros."""
    lib = _load()
    dev = vol.device
    stack = vol if vol.ndim == 4 else vol[None]
    _check(stack, "vol", torch.bfloat16, tuple(stack.shape), dev)
    C, M, Wd, L = stack.shape
    slab_tally(dev)  # made here, where no graph is being captured
    boxes = torch.empty((C, M, 4), dtype=torch.int32, device=dev)
    err = lib.sw_content_boxes(stack.data_ptr(), C * M, Wd, L, boxes.data_ptr(), _stream(dev))
    _raise_on(err, "sw_content_boxes")
    LAUNCHES["sw_content_boxes"] += 1
    return boxes


def accumulate(vol, params, boxes, *, Iu: int, Iv: int, eps: float, k0: int,
               k1: int) -> torch.Tensor:
    """K1. ``vol`` (M, Wd, L) bf16, ``params`` (B, 8) f32
    ``[s0, s1, s2, sgn, u0, du, v0, dv]``, ``boxes`` (M, 4) int32, the
    volume's :func:`content_boxes` -> (B, Iu, Iv) f32."""
    lib = _load()
    dev = vol.device
    M, Wd, L = vol.shape
    B = params.shape[0]
    _check(vol, "vol", torch.bfloat16, (M, Wd, L), dev)
    _check(params, "params", torch.float32, (B, 8), dev)
    _check(boxes, "boxes", torch.int32, (M, 4), dev)
    if not 0 <= k0 <= k1 <= M:
        raise ValueError(f"slab bounds [{k0}, {k1}) outside [0, {M}]")
    out = torch.empty((B, Iu, Iv), dtype=torch.float32, device=dev)
    err = lib.sw_accumulate(vol.data_ptr(), Wd, L, boxes.data_ptr(), params.data_ptr(),
                            out.data_ptr(), B, Iu, Iv, float(eps), int(k0), int(k1),
                            slab_tally(dev).data_ptr(), _stream(dev))
    _raise_on(err, "sw_accumulate")
    LAUNCHES["sw_accumulate"] += 1
    return out


def _warp_inputs(I, uc, vc, ws):
    dev = I.device
    B, Iu, Iv = I.shape
    R = uc.shape[1]
    _check(I, "I", torch.float32, (B, Iu, Iv), dev)
    for name, x in (("uc", uc), ("vc", vc), ("ws", ws)):
        _check(x, name, torch.float32, (B, R), dev)
    return dev, B, Iu, Iv, R


# K2/K3 launch plan (its times on the H100: PERF.md §6): P, the pixels per
# thread, grows while the grid keeps WARP_THREADS_PER_SM[grads] threads on
# each of the card's SMs (K3, with three stores per pixel, gains from wider
# vectors sooner than K2); then the largest block that still gives every SM
# a block
WARP_SMS = 132  # SMs of an H100 SXM, the default count
WARP_THREADS_PER_SM = {False: 768, True: 384}


@functools.lru_cache(maxsize=None)
def warp_plan(B: int, R: int, grads: bool = False, sms: int = WARP_SMS) -> tuple[int, int]:
    """(threads per block, pixels per thread) of K2 (``grads`` False) or K3
    for B x R pixels on a card of ``sms`` SMs."""
    n = B * R
    pixels = next((p for p in (4, 2) if n // p >= WARP_THREADS_PER_SM[grads] * sms), 1)
    threads = next((t for t in (256, 128) if -(-n // (t * pixels)) >= sms), 64)
    return threads, pixels


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """SMs of the CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def warp(I, uc, vc, ws) -> torch.Tensor:
    """K2. Slope image ``I`` (B, Iu, Iv) f32 sampled at (uc, vc) (B, R),
    times ``ws`` -> (B, R) f32."""
    lib = _load()
    dev, B, Iu, Iv, R = _warp_inputs(I, uc, vc, ws)
    out = torch.empty((B, R), dtype=torch.float32, device=dev)
    err = lib.sw_warp(I.data_ptr(), uc.data_ptr(), vc.data_ptr(), ws.data_ptr(), out.data_ptr(),
                      B, Iu, Iv, R, *warp_plan(B, R, False, sm_count(dev)), _stream(dev))
    _raise_on(err, "sw_warp")
    LAUNCHES["sw_warp"] += 1
    return out


def warp_with_grads(I, uc, vc, ws):
    """K3. (bilerp, d/duc, d/dvc), each (B, R) f32, views of one (3, B, R)
    buffer; ``ws`` only masks."""
    lib = _load()
    dev, B, Iu, Iv, R = _warp_inputs(I, uc, vc, ws)
    out = torch.empty((3, B, R), dtype=torch.float32, device=dev)
    err = lib.sw_warp_grads(I.data_ptr(), uc.data_ptr(), vc.data_ptr(), ws.data_ptr(),
                            *(o.data_ptr() for o in out), B, Iu, Iv, R,
                            *warp_plan(B, R, True, sm_count(dev)), _stream(dev))
    _raise_on(err, "sw_warp_grads")
    LAUNCHES["sw_warp_grads"] += 1
    return tuple(out)


def accumulate_adjoint(vol, params, ibar, boxes, *, eps: float, k0: int, k1: int):
    """K4. ``ibar`` (B, Iu, Iv) bf16, ``boxes`` as for K1 -> per-row
    cotangent sums gw (B, Iu) and gl (B, Iv), f32."""
    lib = _load()
    dev = vol.device
    M, Wd, L = vol.shape
    B, Iu, Iv = ibar.shape
    _check(vol, "vol", torch.bfloat16, (M, Wd, L), dev)
    _check(params, "params", torch.float32, (B, 8), dev)
    _check(ibar, "ibar", torch.bfloat16, (B, Iu, Iv), dev)
    _check(boxes, "boxes", torch.int32, (M, 4), dev)
    if not 0 <= k0 <= k1 <= M:
        raise ValueError(f"slab bounds [{k0}, {k1}) outside [0, {M}]")
    nbx, nby = ctypes.c_int(), ctypes.c_int()
    lib.sw_adjoint_partials_shape(Iu, Iv, ctypes.byref(nbx), ctypes.byref(nby))
    part_gw = torch.empty((B, Iu, nbx.value), dtype=torch.float64, device=dev)
    part_gl = torch.empty((B, Iv, nby.value), dtype=torch.float64, device=dev)
    gw = torch.empty((B, Iu), dtype=torch.float32, device=dev)
    gl = torch.empty((B, Iv), dtype=torch.float32, device=dev)
    err = lib.sw_accumulate_adjoint(
        vol.data_ptr(), Wd, L, boxes.data_ptr(), params.data_ptr(), ibar.data_ptr(),
        part_gw.data_ptr(), part_gl.data_ptr(), gw.data_ptr(), gl.data_ptr(), B, Iu, Iv,
        float(eps), int(k0), int(k1), slab_tally(dev).data_ptr(), _stream(dev),
    )
    _raise_on(err, "sw_accumulate_adjoint")
    LAUNCHES["sw_accumulate_adjoint"] += 1
    return gw, gl


def _slab_inputs(vol, fields):
    dev = vol.device
    M, Wd, L = vol.shape
    _, B, R = fields.shape
    _check(vol, "vol", torch.bfloat16, (M, Wd, L), dev)
    _check(fields, "fields", torch.float32, (7, B, R), dev)
    return dev, M, Wd, L, B, R


def slab_plane_split(B: int, R: int) -> int:
    """Warps that share one ray's planes in K5-K8 for B x R rays."""
    return _load().slab_plane_split(int(B), int(R))


def slab_forward(vol, fields) -> torch.Tensor:
    """K5. ``vol`` (M, Wd, L) bf16, ``fields`` (7, B, R) f32
    ``[s0, s1, s2, d0, d1, d2, ws]`` -> (B, R) f32."""
    lib = _load()
    dev, M, Wd, L, B, R = _slab_inputs(vol, fields)
    out = torch.empty((B, R), dtype=torch.float32, device=dev)
    err = lib.slab_forward(vol.data_ptr(), M, Wd, L, fields.data_ptr(), out.data_ptr(), B, R,
                           _stream(dev))
    _raise_on(err, "slab_forward")
    LAUNCHES["slab_forward"] += 1
    return out


def slab_backward(vol, fields, g) -> torch.Tensor:
    """K6. Cotangent ``g`` (B, R) f32 -> the gradient of <g, K5> with respect
    to the fields, (7, B, R) f32."""
    lib = _load()
    dev, M, Wd, L, B, R = _slab_inputs(vol, fields)
    _check(g, "g", torch.float32, (B, R), dev)
    out = torch.empty((7, B, R), dtype=torch.float32, device=dev)
    err = lib.slab_backward(vol.data_ptr(), M, Wd, L, fields.data_ptr(), g.data_ptr(),
                            out.data_ptr(), B, R, _stream(dev))
    _raise_on(err, "slab_backward")
    LAUNCHES["slab_backward"] += 1
    return out


def slab_channels(vol, labels, chans, fields) -> torch.Tensor:
    """K7. ``labels`` (M, Wd, L) uint8 (the permuted labelmap), ``chans``
    the C - 1 label values (ints, passed to the kernel by value: no copy to
    the device) -> (B, C, R) f32."""
    lib = _load()
    dev, M, Wd, L, B, R = _slab_inputs(vol, fields)
    _check(labels, "labels", torch.uint8, (M, Wd, L), dev)
    values = [int(c) for c in chans]
    n = len(values)
    if n + 1 > lib.slab_max_channels():
        raise ValueError(f"{n + 1} channels; the kernel takes at most {lib.slab_max_channels()}")
    out = torch.empty((B, n + 1, R), dtype=torch.float32, device=dev)
    err = lib.slab_channels(vol.data_ptr(), labels.data_ptr(), M, Wd, L,
                            (ctypes.c_int * max(n, 1))(*values), n, fields.data_ptr(),
                            out.data_ptr(), B, R, _stream(dev))
    _raise_on(err, "slab_channels")
    LAUNCHES["slab_channels"] += 1
    return out


def slab_siddon(vol, fields) -> torch.Tensor:
    """K8. Exact Siddon forward -> (B, R) f32."""
    lib = _load()
    dev, M, Wd, L, B, R = _slab_inputs(vol, fields)
    out = torch.empty((B, R), dtype=torch.float32, device=dev)
    err = lib.slab_siddon(vol.data_ptr(), M, Wd, L, fields.data_ptr(), out.data_ptr(), B, R,
                          _stream(dev))
    _raise_on(err, "slab_siddon")
    LAUNCHES["slab_siddon"] += 1
    return out


def rays_adjoint(g, q) -> torch.Tensor:
    """The pose cotangent of ``q @ R^T + t`` over a batch of poses that share
    the points ``q`` (N, 3), given the cotangent ``g`` (B, N, 3) of the
    result: (B, 4, 4), ``[sum_n g (x) q | sum_n g]`` over a zero bottom row,
    summed in double. Both float32 or both float64."""
    lib = _load()
    dev = g.device
    if g.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"g has dtype {g.dtype}, expected float32 or float64")
    B, N = g.shape[:2]
    _check(g, "g", g.dtype, (B, N, 3), dev)
    _check(q, "q", g.dtype, (N, 3), dev)
    part = torch.empty((B, 12, lib.rays_adjoint_blocks(N)), dtype=torch.float64, device=dev)
    out = torch.empty((B, 4, 4), dtype=g.dtype, device=dev)
    err = lib.rays_adjoint(g.data_ptr(), q.data_ptr(), part.data_ptr(), out.data_ptr(), B, N,
                           int(g.dtype == torch.float64), _stream(dev))
    _raise_on(err, "rays_adjoint")
    LAUNCHES["rays_adjoint"] += 1
    return out
