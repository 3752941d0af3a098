#!/usr/bin/env python3
"""Device times of the slab path's K5 (slab_forward) and K6 (slab_backward)
kernels, for this checkout, variants of its constants and other checkouts,
on one GPU.

Each source's ``xvr_tpu_torch/csrc/slab.cu`` is built into a library of its
own (one ``nvcc -Xptxas -v`` per source, all started together; the register
report is printed). On the bench scene of ``chip_smoke.py``, at the slab
path's two shapes (the coarse sweep's B=16 at 60^2 and the fine stage's B=4
at 239^2), every source's K5 and K6 are held against their plain versions
with ``chip_smoke.py``'s tolerances and against a second call bit for bit,
then timed by torch.profiler device time (10 calls) and CUDA events (20
back-to-back calls): the sources in order, then in reverse order, so that a
drift of the card's clock shows.

Sources:

  this                              this checkout's slab.cu (always first)
  --variant NAME:CONST=V[,CONST=V]  this checkout's slab.cu with the named
                                    constexpr constants at its top set to V
  --port DIR                        the slab.cu of another checkout at DIR,
                                    for example an unpacked parent commit

Prints one line per measurement and, last, one JSON object with every
record; ``--out`` writes that object to a file as well.

Usage: python3 scripts/chip_slab_times.py [--variant SPEC ...] [--port DIR ...] [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from functools import partial
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SLAB = Path("xvr_tpu_torch") / "csrc" / "slab.cu"


def load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def variant_source(text: str, overrides: dict) -> str:
    """``text`` with each ``constexpr <type> NAME = ...;`` set to its value."""
    for name, value in overrides.items():
        text, n = re.subn(rf"(constexpr\s+\w+\s+{name}\s*=\s*)[^;]+;", rf"\g<1>{value};", text)
        if n != 1:
            raise SystemExit(f"--variant: the source has no constant {name}")
    return text


def build(sources: dict, out_dir: Path, cuda, source: str = SLAB.name,
          entries=("slab_forward_kernel", "slab_backward_kernel")) -> dict:
    """One nvcc per source text of the kernel file ``source``, all started
    together -> name -> (library, the compiler's register report for the
    device kernels whose names contain one of ``entries``)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = Path(source).stem
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        src = out_dir / f"{stem}_{i}.cu"
        src.write_text(text)
        lib = out_dir / f"lib{stem}_{i}.so"
        cmd = [cuda._nvcc(), "-Xptxas", "-v", *cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
               "-fPIC", *cuda.SOURCE_FLAGS.get(source, ()), "-shared", "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} ({proc.returncode}):\n{text}")
        report, entry = [], None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1) if any(k in m.group(1) for k in entries) else None
            elif entry and ("registers" in line or "spill" in line):
                short = next(k for k in entries if k in entry)
                report.append(f"{short} ({entry}): {line.split('info    :')[-1].strip()}")
        built[name] = (lib, report)
    return built


class SlabLib:
    """K5 and K6 of one built library, called as the port's wrappers call them."""

    def __init__(self, path: Path):
        import torch

        P, I = ctypes.c_void_p, ctypes.c_int
        lib = ctypes.CDLL(str(path))
        lib.slab_forward.argtypes = [P, I, I, I, P, P, I, I, P]
        lib.slab_backward.argtypes = [P, I, I, I, P, P, P, I, I, P]
        lib.slab_forward.restype = lib.slab_backward.restype = I
        self.lib, self.torch = lib, torch

    def split(self, B: int, R: int):
        try:
            fn = self.lib.slab_plane_split
        except AttributeError:  # a checkout from before the plane split
            return None
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        return fn(B, R)

    def _stream(self) -> int:
        return self.torch.cuda.current_stream().cuda_stream

    def forward(self, vol, fields):
        M, Wd, L = vol.shape
        _, B, R = fields.shape
        out = self.torch.empty((B, R), dtype=self.torch.float32, device=vol.device)
        err = self.lib.slab_forward(vol.data_ptr(), M, Wd, L, fields.data_ptr(), out.data_ptr(), B,
                                    R, self._stream())
        if err:
            raise RuntimeError(f"slab_forward: CUDA error {err} at launch")
        return out

    def backward(self, vol, fields, g):
        M, Wd, L = vol.shape
        _, B, R = fields.shape
        out = self.torch.empty((7, B, R), dtype=self.torch.float32, device=vol.device)
        err = self.lib.slab_backward(vol.data_ptr(), M, Wd, L, fields.data_ptr(), g.data_ptr(),
                                     out.data_ptr(), B, R, self._stream())
        if err:
            raise RuntimeError(f"slab_backward: CUDA error {err} at launch")
        return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME:CONST=VALUE[,CONST=VALUE] (repeatable)")
    ap.add_argument("--port", action="append", default=[],
                    help="another checkout whose slab.cu to time (repeatable)")
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_slab_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    smoke = load_module("chip_smoke_helpers", REPO / "chip_smoke.py")
    from xvr_tpu_torch.render import _cuda

    smi = smoke.nvidia_smi()
    print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    base = (REPO / SLAB).read_text()
    sources = {"this": base}
    for spec in opts.variant:
        name, _, assigns = spec.partition(":")
        sources[name] = variant_source(base, dict(a.split("=", 1) for a in assigns.split(",")))
    for d in opts.port:
        path = Path(d).resolve() / SLAB
        if not path.is_file():
            raise SystemExit(f"--port {d}: no {SLAB} there")
        sources[f"port {d}"] = path.read_text()
    built = build(sources, _cuda.BUILD_DIR / "slab_times", _cuda)
    libs = {}
    for name, (path, report) in built.items():
        libs[name] = SlabLib(path)
        for line in report:
            print(f"ptxas {name}: {line}", flush=True)

    hu, aff, _ = smoke.build_phantom(256)
    _, proj, pose16, pose4 = smoke.bench_projector(hu, aff)
    slab_proj = proj.with_pallas(pose16[:1])
    vol = slab_proj.pack_for_pallas()[0]
    records = {name: dict(registers=built[name][1], shapes={}) for name in sources}
    shapes = smoke.slab_path_inputs(slab_proj, pose16, pose4)
    for x in shapes:
        tag, fields, g = x["tag"], x["fields"], x["g"]
        _, B, R = fields.shape
        for name, lib in libs.items():
            label = f"{name} {tag}"
            k5 = lib.forward(vol, fields)
            e5, _ = smoke.check_k5(k5, vol, fields, label)
            k6 = lib.backward(vol, fields, g)
            e6 = smoke.check_k6(k6, vol, fields, g, label)
            bits = torch.equal(k5, lib.forward(vol, fields)) and torch.equal(
                k6, lib.backward(vol, fields, g))
            print(f"  {label}: split {lib.split(B, R)}, second call bit-identical {bits}", flush=True)
            if not bits:
                raise AssertionError(f"{label}: calls differ")
            records[name]["shapes"][tag] = dict(split=lib.split(B, R), k5_err=e5, k6_err=e6,
                                                slab_forward=[], slab_backward=[])
    for order in (list(libs), list(libs)[::-1]):
        for x in shapes:
            tag, fields, g = x["tag"], x["fields"], x["g"]
            for name in order:
                lib = libs[name]
                for kernel, fn in (("slab_forward", partial(lib.forward, vol, fields)),
                                   ("slab_backward", partial(lib.backward, vol, fields, g))):
                    dev_ms = smoke.library_device_ms(fn)[0]
                    ev_ms = smoke.cuda_time_ms(fn, 20)
                    records[name]["shapes"][tag][kernel].append(dict(device_ms=dev_ms, events_ms=ev_ms))
                    dev = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
                    print(f"time {name} {kernel} [{tag}]: device {dev}, events {ev_ms:.4f} ms",
                          flush=True)
    line = json.dumps(dict(device=smi, sources=list(sources), records=records))
    if opts.out:
        Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
