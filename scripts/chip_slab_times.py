#!/usr/bin/env python3
"""Device times of the slab kernels K5 (slab_forward), K6 (slab_backward),
K7 (slab_channels) and K8 (slab_siddon), for this checkout, variants of its
constants and other checkouts, on one GPU.

Each source's ``xvr_tpu_torch/csrc/slab.cu`` is built into a library of its
own (one ``nvcc -Xptxas -v`` per source, all started together; the register
and stack-frame report of the timed kernels is printed). On the bench scene
of ``chip_smoke.py``, at the slab path's four shapes (the coarse sweep's B=16
at 60^2, then B=4 at 60^2, 120^2 and 239^2) and the trainer's (B=116 at
128^2, ``chip_smoke.trainer_inputs``), every source's kernels are held
against their plain versions with ``chip_smoke.py``'s tolerances (at the
trainer's shape on its first 8 images) and against a second call bit for
bit, then timed by torch.profiler device time (10 calls) and CUDA events (20
back-to-back calls): the sources in order, then in reverse order, so that a
drift of the card's clock shows.

Sources:

  this                              this checkout's slab.cu (always first)
  --variant NAME:CONST=V[,CONST=V]  this checkout's slab.cu with the named
                                    constexpr constants at its top set to V
                                    (e.g. K7_REG_CHANNELS=0, K8_RECIPROCAL=false,
                                    K7_UNROLL=4)
  --port DIR                        the slab.cu of another checkout at DIR,
                                    for example an unpacked parent commit

``--kernels`` picks the kernels (default slab_forward,slab_backward).

Prints one line per measurement and, last, one JSON object with every
record; ``--out`` writes that object to a file as well.

Usage: python3 scripts/chip_slab_times.py [--kernels K,K] [--variant SPEC ...]
                                          [--port DIR ...] [--out FILE]
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


KERNELS = ("slab_forward", "slab_backward", "slab_channels", "slab_siddon")
CHANS = (1, 2)  # chip_smoke.py's label channels


class SlabLib:
    """The slab kernels of one built library, called as the port's wrappers
    call them. ``chans_by_value``: its slab_channels takes the channel values
    as a host array (else, as in earlier checkouts, a device int32 array)."""

    def __init__(self, path: Path, chans_by_value: bool):
        import torch

        P, I = ctypes.c_void_p, ctypes.c_int
        lib = ctypes.CDLL(str(path))
        lib.slab_forward.argtypes = [P, I, I, I, P, P, I, I, P]
        lib.slab_backward.argtypes = [P, I, I, I, P, P, P, I, I, P]
        lib.slab_siddon.argtypes = [P, I, I, I, P, P, I, I, P]
        chans_arg = ctypes.POINTER(I) if chans_by_value else P
        lib.slab_channels.argtypes = [P, P, I, I, I, chans_arg, I, P, P, I, I, P]
        for fn in KERNELS:
            getattr(lib, fn).restype = I
        self.lib, self.torch, self.by_value = lib, torch, chans_by_value
        self._chans = {}

    def split(self, B: int, R: int):
        try:
            fn = self.lib.slab_plane_split
        except AttributeError:  # a checkout from before the plane split
            return None
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        return fn(B, R)

    def _stream(self) -> int:
        return self.torch.cuda.current_stream().cuda_stream

    def _raise(self, err: int, name: str):
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")

    def forward(self, vol, fields):
        M, Wd, L = vol.shape
        _, B, R = fields.shape
        out = self.torch.empty((B, R), dtype=self.torch.float32, device=vol.device)
        self._raise(self.lib.slab_forward(vol.data_ptr(), M, Wd, L, fields.data_ptr(),
                                          out.data_ptr(), B, R, self._stream()), "slab_forward")
        return out

    def backward(self, vol, fields, g):
        M, Wd, L = vol.shape
        _, B, R = fields.shape
        out = self.torch.empty((7, B, R), dtype=self.torch.float32, device=vol.device)
        self._raise(self.lib.slab_backward(vol.data_ptr(), M, Wd, L, fields.data_ptr(),
                                           g.data_ptr(), out.data_ptr(), B, R, self._stream()),
                    "slab_backward")
        return out

    def channels(self, vol, labels, chans, fields):
        M, Wd, L = vol.shape
        _, B, R = fields.shape
        n = len(chans)
        if self.by_value:
            arg = (ctypes.c_int * max(n, 1))(*chans)
        else:  # made once, so that no copy to the device is timed
            if chans not in self._chans:
                self._chans[chans] = self.torch.tensor(chans, dtype=self.torch.int32,
                                                       device=vol.device)
            arg = self._chans[chans].data_ptr()
        out = self.torch.empty((B, n + 1, R), dtype=self.torch.float32, device=vol.device)
        self._raise(self.lib.slab_channels(vol.data_ptr(), labels.data_ptr(), M, Wd, L, arg, n,
                                           fields.data_ptr(), out.data_ptr(), B, R,
                                           self._stream()), "slab_channels")
        return out

    def siddon(self, vol, fields):
        M, Wd, L = vol.shape
        _, B, R = fields.shape
        out = self.torch.empty((B, R), dtype=self.torch.float32, device=vol.device)
        self._raise(self.lib.slab_siddon(vol.data_ptr(), M, Wd, L, fields.data_ptr(),
                                         out.data_ptr(), B, R, self._stream()), "slab_siddon")
        return out

    def calls(self, x, vol, lab):
        """kernel -> its call on shape ``x``'s inputs."""
        f, g = x["fields"], x["g"]
        return dict(slab_forward=partial(self.forward, vol, f),
                    slab_backward=partial(self.backward, vol, f, g),
                    slab_channels=partial(self.channels, vol, lab, CHANS, f),
                    slab_siddon=partial(self.siddon, vol, f))


def check(smoke, kernel, got, vol, lab, x, label):
    """``got`` against the plain version with chip_smoke.py's tolerances, on
    the images x["check"] selects -> max abs error."""
    sel = x["check"]
    fields = x["fields"][:, sel].contiguous()
    got = got[:, sel] if kernel == "slab_backward" else got[sel]
    if kernel == "slab_forward":
        return smoke.check_k5(got, vol, fields, label)[0]
    if kernel == "slab_backward":
        return smoke.check_k6(got, vol, fields, x["g"][sel].contiguous(), label)
    if kernel == "slab_channels":
        from xvr_tpu_torch.render import pallas as sp

        r5 = sp._slab_forward(vol, fields.double())
        return smoke.check_k7(got.contiguous(), vol, lab, CHANS, fields, label, r5)
    return smoke.check_k8(got.contiguous(), vol, fields, label)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="slab_forward,slab_backward",
                    help=f"comma-separated, of {','.join(KERNELS)}")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME:CONST=VALUE[,CONST=VALUE] (repeatable)")
    ap.add_argument("--port", action="append", default=[],
                    help="another checkout whose slab.cu to time (repeatable)")
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    kernels = [k for k in opts.kernels.split(",") if k]
    unknown = sorted(set(kernels) - set(KERNELS))
    if unknown:
        raise SystemExit(f"--kernels: unknown {unknown}")

    import torch

    if not torch.cuda.is_available():
        print("chip_slab_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    smoke = load_module("chip_smoke_helpers", REPO / "chip_smoke.py")
    from xvr_tpu_torch.render import _cuda
    from xvr_tpu_torch.render import pallas as sp

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
    built = build(sources, _cuda.build_dir() / "slab_times", _cuda,
                  entries=tuple(f"{k}_kernel" for k in kernels))
    libs = {}
    for name, (path, report) in built.items():
        # a slab.cu whose C entry takes the channel values from the host
        libs[name] = SlabLib(path, chans_by_value="chan_values" in sources[name])
        for line in report:
            print(f"ptxas {name}: {line}", flush=True)

    hu, aff, _ = smoke.build_phantom(256)
    volume, proj, pose16, pose4 = smoke.bench_projector(hu, aff)
    slab_proj = proj.with_pallas(pose16[:1])
    vol = slab_proj.pack_for_pallas()[0]
    lab = sp.pack_labels(volume.mask, slab_proj.pallas_perm)
    shapes = [dict(x, vol=vol, lab=lab, check=slice(None))
              for x in smoke.slab_path_inputs(slab_proj, pose16, pose4)]
    t_vol, t_lab, t_fields = smoke.trainer_inputs(volume)
    _, B, R = t_fields.shape
    g = torch.randn((B, R), generator=torch.Generator(device="cuda").manual_seed(2), device="cuda")
    shapes.append(dict(tag=f"trainer B={B} det {smoke.TRAINER['height']}^2", fields=t_fields,
                       g=g, vol=t_vol, lab=t_lab, check=slice(0, smoke.TRAINER_CHECKED)))
    records = {name: dict(registers=built[name][1], shapes={}) for name in sources}
    for x in shapes:
        _, B, R = x["fields"].shape
        for name, lib in libs.items():
            label = f"{name} {x['tag']}"
            calls = lib.calls(x, x["vol"], x["lab"])
            rec = records[name]["shapes"][x["tag"]] = dict(split=lib.split(B, R))
            for kernel in kernels:
                first = calls[kernel]()
                rec[f"{kernel}_err"] = check(smoke, kernel, first, x["vol"], x["lab"], x, label)
                bits = torch.equal(first, calls[kernel]())
                print(f"  {label} {kernel}: split {rec['split']}, second call bit-identical "
                      f"{bits}", flush=True)
                if not bits:
                    raise AssertionError(f"{label} {kernel}: calls differ")
                rec[kernel] = []
    for order in (list(libs), list(libs)[::-1]):
        for x in shapes:
            for name in order:
                calls = libs[name].calls(x, x["vol"], x["lab"])
                for kernel in kernels:
                    fn = calls[kernel]
                    dev_ms = smoke.library_device_ms(fn)[0]
                    ev_ms = smoke.cuda_time_ms(fn, 20)
                    records[name]["shapes"][x["tag"]][kernel].append(
                        dict(device_ms=dev_ms, events_ms=ev_ms))
                    dev = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
                    print(f"time {name} {kernel} [{x['tag']}]: device {dev}, events {ev_ms:.4f} ms",
                          flush=True)
    line = json.dumps(dict(device=smi, sources=list(sources), kernels=kernels, records=records))
    if opts.out:
        Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
