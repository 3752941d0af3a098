#!/usr/bin/env python3
"""Device times of the shear-warp path's K2 (sw_warp) and K3 (sw_warp_grads)
kernels, for this checkout, its launch plans, variants of its constants and
other checkouts, beside F.grid_sample, on one GPU.

Each source's ``xvr_tpu_torch/csrc/shearwarp.cu`` is built into a library of
its own (one ``nvcc -Xptxas -v`` per source, all started together; the
register report is printed). On the bench scene of ``chip_smoke.py``, at the
four shapes the registration renders (``chip_smoke.stage_cases``: B=16 at 60^2,
B=4 at 60^2, 120^2 and 239^2), the slope image is accumulated by this
checkout's K1, and every source's K2 and K3 are held against their float64
plain versions with ``chip_smoke.py``'s tolerances, against a second call bit
for bit, and against the first ``--port`` source bit for bit (reported, not
required). Then each is timed by torch.profiler device time (10 calls) and
CUDA events (20 back-to-back calls), and F.grid_sample on the same image and
points beside them: the sources in order, then in reverse order, so that a
drift of the card's clock shows. Last, for every source, the device span from
the start of K1 to the end of the K2 that follows it (median over 20 pairs
from the profiler's trace), which is how a programmatic dependent launch of
K2 is judged.

Sources:

  this                              this checkout's shearwarp.cu (always first),
                                    launched with render/_cuda.py warp_plan
  --plans all                       also this checkout's kernels with every
                                    (threads, pixels per thread) the launcher
                                    takes, 64/128/256 x 1/2/4
  --variant NAME:CONST=V[,CONST=V]  this checkout's shearwarp.cu with the named
                                    constexpr constants set to V (for example
                                    K1's tile, TJ=32, which moves the span)
  --port DIR                        the shearwarp.cu of another checkout at DIR,
                                    for example an unpacked parent commit

Prints one line per measurement and, last, one JSON object with every
record; ``--out`` writes that object to a file as well.

Usage: python3 scripts/chip_warp_times.py [--plans rule|all] [--variant SPEC ...]
                                          [--port DIR ...] [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import statistics
import sys
from functools import partial
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCE = Path("xvr_tpu_torch") / "csrc" / "shearwarp.cu"
ENTRIES = ("sw_accumulate_tiled_kernel", "sw_warp_kernel", "sw_warp_grads_kernel")
PLANS = [(t, p) for p in (1, 2, 4) for t in (64, 128, 256)]
SPAN_PAIRS = 20


def load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class WarpLib:
    """K1, K2 and K3 of one built library, called as the port's wrappers
    call them. ``planned``: the launcher takes (threads, pixels per thread);
    a checkout from before the launch plan takes neither. A library with
    ``sw_content_boxes`` has K1 take the volume's content boxes (made once
    per volume by that library) and a slab tally; one from before takes
    neither."""

    def __init__(self, path: Path, planned: bool):
        import torch

        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib = ctypes.CDLL(str(path))
        plan = [I, I] if planned else []
        self.boxed = hasattr(lib, "sw_content_boxes")
        if self.boxed:
            lib.sw_accumulate.argtypes = [P, I, I, P, P, P, I, I, I, F, I, I, P, P]
            lib.sw_content_boxes.argtypes = [P, I, I, I, P, P]
            lib.sw_content_boxes.restype = I
        else:
            lib.sw_accumulate.argtypes = [P, I, I, P, P, I, I, I, F, I, I, P]
        lib.sw_warp.argtypes = [P, P, P, P, P, I, I, I, I, *plan, P]
        lib.sw_warp_grads.argtypes = [P, P, P, P, P, P, P, I, I, I, I, *plan, P]
        for fn in (lib.sw_accumulate, lib.sw_warp, lib.sw_warp_grads):
            fn.restype = I
        self.lib, self.planned, self.torch = lib, planned, torch
        self.boxes = {}  # volume's address -> (its content boxes, a slab tally)

    def _stream(self) -> int:
        return self.torch.cuda.current_stream().cuda_stream

    def _plan(self, B, R, plan, grads, dev):
        if not self.planned:
            return ()
        from xvr_tpu_torch.render import _cuda

        return plan or _cuda.warp_plan(B, R, grads, _cuda.sm_count(dev))

    def _content(self, vol) -> list:
        """[] for a library from before the content skip, else the
        arguments K1 takes for ``vol``: its content boxes, and a tally."""
        if not self.boxed:
            return []
        torch = self.torch
        M, Wd, L = vol.shape
        key = (vol.data_ptr(), M, Wd, L)
        if key not in self.boxes:
            boxes = torch.empty((M, 4), dtype=torch.int32, device=vol.device)
            err = self.lib.sw_content_boxes(vol.data_ptr(), M, Wd, L, boxes.data_ptr(),
                                            self._stream())
            if err:
                raise RuntimeError(f"sw_content_boxes: CUDA error {err} at launch")
            self.boxes[key] = (boxes, torch.zeros(2, dtype=torch.int64, device=vol.device))
        return list(self.boxes[key])

    def accumulate(self, vol, params, Iu, Iv, eps=1.0):
        M, Wd, L = vol.shape
        B = params.shape[0]
        out = self.torch.empty((B, Iu, Iv), dtype=self.torch.float32, device=vol.device)
        content = self._content(vol)
        err = self.lib.sw_accumulate(
            vol.data_ptr(), Wd, L, *(x.data_ptr() for x in content[:1]), params.data_ptr(),
            out.data_ptr(), B, Iu, Iv, float(eps), 0, M, *(x.data_ptr() for x in content[1:]),
            self._stream())
        if err:
            raise RuntimeError(f"sw_accumulate: CUDA error {err} at launch")
        return out

    def warp(self, I, uc, vc, ws, plan=None):
        B, Iu, Iv = I.shape
        R = uc.shape[1]
        out = self.torch.empty((B, R), dtype=self.torch.float32, device=I.device)
        err = self.lib.sw_warp(I.data_ptr(), uc.data_ptr(), vc.data_ptr(), ws.data_ptr(),
                               out.data_ptr(), B, Iu, Iv, R,
                               *self._plan(B, R, plan, False, I.device), self._stream())
        if err:
            raise RuntimeError(f"sw_warp: CUDA error {err} at launch")
        return out

    def grads(self, I, uc, vc, ws, plan=None):
        B, Iu, Iv = I.shape
        R = uc.shape[1]
        out = self.torch.empty((3, B, R), dtype=self.torch.float32, device=I.device)
        err = self.lib.sw_warp_grads(I.data_ptr(), uc.data_ptr(), vc.data_ptr(), ws.data_ptr(),
                                     *(o.data_ptr() for o in out), B, Iu, Iv, R,
                                     *self._plan(B, R, plan, True, I.device), self._stream())
        if err:
            raise RuntimeError(f"sw_warp_grads: CUDA error {err} at launch")
        return out


def span_ms(k1, k2, pairs: int = SPAN_PAIRS):
    """Median device span from the start of K1 to the end of the K2 after it,
    over ``pairs`` back-to-back (k1(), k2()) calls, from the profiler's trace;
    None when the trace holds no device kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    k1()
    k2()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(pairs):
            k1()
            k2()
        torch.cuda.synchronize()
    kern = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if getattr(e, "device_type", None) == DeviceType.CUDA)
    spans, start = [], None
    for t0, t1, name in kern:
        if re.search(r"\bsw_accumulate_tiled_kernel\b", name):
            start = t0
        elif re.search(r"\bsw_warp_kernel\b", name) and start is not None:
            spans.append((t1 - start) / 1e3)
            start = None
    return statistics.median(spans) if spans else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plans", choices=("rule", "all"), default="rule")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME:CONST=VALUE[,CONST=VALUE] (repeatable)")
    ap.add_argument("--port", action="append", default=[],
                    help="another checkout whose shearwarp.cu to time (repeatable)")
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_warp_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    smoke = load_module("chip_smoke_helpers", REPO / "chip_smoke.py")
    slab_times = load_module("chip_slab_times_helpers", REPO / "scripts" / "chip_slab_times.py")
    from xvr_tpu_torch.render import _cuda
    from xvr_tpu_torch.render import shearwarp as sw

    smi = smoke.nvidia_smi()
    print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    base = (REPO / SOURCE).read_text()
    sources = {"this": base}
    for spec in opts.variant:
        name, _, assigns = spec.partition(":")
        sources[name] = slab_times.variant_source(base, dict(a.split("=", 1)
                                                             for a in assigns.split(",")))
    ports = []
    for d in opts.port:
        path = Path(d).resolve() / SOURCE
        if not path.is_file():
            raise SystemExit(f"--port {d}: no {SOURCE} there")
        ports.append(f"port {d}")
        sources[ports[-1]] = path.read_text()
    built = slab_times.build(sources, _cuda.build_dir() / "warp_times", _cuda, source=SOURCE.name,
                             entries=ENTRIES)
    libs = {}
    for name, (path, report) in built.items():
        libs[name] = WarpLib(path, planned=bool(re.search(r"int sw_warp\([^)]*threads",
                                                          sources[name])))
        for line in report:
            print(f"ptxas {name}: {line}", flush=True)
    # (label, library, plan or None for the source's own)
    entries = [("this", "this", None)]
    if opts.plans == "all":
        entries += [(f"this T={t} P={p}", "this", (t, p)) for t, p in PLANS]
    entries += [(name, name, None) for name in sources if name != "this"]
    ref = ports[0] if ports else None

    hu, aff, _ = smoke.build_phantom(256)
    _, proj, pose16, pose4 = smoke.bench_projector(hu, aff)
    sw_proj = proj.with_shearwarp(pose16[:1])
    vol = sw_proj.prepare_for_shearwarp()
    shapes = []
    for label, pose, scale in smoke.stage_cases(sw_proj, pose16, pose4):
        p = sw_proj.rescale_detector(scale)
        x = smoke.path_inputs(p, pose, seed=1)
        Iu, Iv = x["grid"]
        B, R = x["uc"].shape
        params = sw._params(x["s"], x["sgn"], x["u0"], x["du"], x["v0"], x["dv"])
        I = libs["this"].accumulate(vol, params, Iu, Iv)
        tag = f"{label} det {p.detector.height}x{p.detector.width} grid {Iu}x{Iv}"
        grid = torch.stack([(x["vc"] / (Iv - 1)) * 2 - 1, (x["uc"] / (Iu - 1)) * 2 - 1], -1)
        shapes.append(dict(tag=tag, B=B, R=R, I=I, params=params, Iu=Iu, Iv=Iv,
                           w=(x["uc"], x["vc"], x["ws"]), grid=grid.reshape(B, 1, R, 2)))
        for name, grads in (("K2", False), ("K3", True)):
            t, pix = _cuda.warp_plan(B, R, grads, _cuda.sm_count(I.device))
            print(f"plan {name} [{tag}]: {t} threads x {pix} pixels per thread, "
                  f"{-(-B * R // (t * pix))} blocks", flush=True)

    records = {label: dict(shapes={}) for label, _, _ in entries}
    records["grid_sample"] = dict(shapes={})
    for s in shapes:
        tag, I, w = s["tag"], s["I"], s["w"]
        I64, w64 = I.double(), [a.double() for a in w]
        r2 = sw._warp_plain(I64, *w64, bf16=False)
        r3 = sw._warp_with_grads_plain(I64, *w64, bf16=False)
        outs = {}
        for label, name, plan in entries:
            lib = libs[name]
            k2, k3 = lib.warp(I, *w, plan=plan), lib.grads(I, *w, plan=plan)
            e2 = smoke.check("K2 sw_warp", k2.double(), r2, f"{label} {tag}",
                             1e-5 * float(r2.abs().max()))
            e3 = max(smoke.check(f"K3 sw_warp_grads[{o}]", k3[o].double(), r3[o], f"{label} {tag}",
                                 1e-5 * float(I64.abs().max())) for o in range(3))
            bits = torch.equal(k2, lib.warp(I, *w, plan=plan)) and torch.equal(
                k3, lib.grads(I, *w, plan=plan))
            if not bits:
                raise AssertionError(f"{label} {tag}: calls differ")
            outs[label] = (k2, k3)
            records[label]["shapes"][tag] = dict(k2_err=e2, k3_err=e3, sw_warp=[],
                                                 sw_warp_grads=[], span=[])
        for label, _, _ in entries:
            if ref is None:
                break
            same = [torch.equal(a, b) for a, b in zip(outs[label], outs[ref])]
            records[label]["shapes"][tag]["same_bits_as"] = {ref: same}
            print(f"  {label} [{tag}]: K2, K3 bit-identical to {ref}: {same}", flush=True)
        records["grid_sample"]["shapes"][tag] = dict(grid_sample=[])

    for order in (entries, entries[::-1]):
        for s in shapes:
            tag, I, w = s["tag"], s["I"], s["w"]
            gs = partial(F.grid_sample, I[:, None], s["grid"], mode="bilinear", align_corners=True)
            timed = [("grid_sample", "grid_sample", gs)]
            for label, name, plan in order:
                lib = libs[name]
                timed += [(label, "sw_warp", partial(lib.warp, I, *w, plan=plan)),
                          (label, "sw_warp_grads", partial(lib.grads, I, *w, plan=plan))]
            for label, kernel, fn in timed:
                dev_ms = smoke.library_device_ms(fn)[0]
                ev_ms = smoke.cuda_time_ms(fn, 20)
                records[label]["shapes"][tag][kernel].append(dict(device_ms=dev_ms, events_ms=ev_ms))
                dev = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
                print(f"time {label} {kernel} [{tag}]: device {dev}, events {ev_ms:.4f} ms",
                      flush=True)
            for label, name, plan in order:
                if plan is not None:
                    continue
                lib = libs[name]
                k1 = partial(lib.accumulate, vol, s["params"], s["Iu"], s["Iv"])
                ms = span_ms(k1, partial(lib.warp, I, *w))
                records[label]["shapes"][tag]["span"].append(ms)
                print(f"span {label} K1 start -> K2 end [{tag}]: "
                      f"{'not measured' if ms is None else f'{ms:.4f} ms'}", flush=True)
    line = json.dumps(dict(device=smi, sources=list(sources), entries=[e[0] for e in entries],
                           records=records))
    if opts.out:
        Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
