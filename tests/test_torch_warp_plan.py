"""A CPU model of the launch plan of the warp kernels K2/K3 (csrc/shearwarp.cu).

``render/_cuda.py warp_plan`` picks the threads per block and the P pixels
per thread of K2 (``sw_warp``) and K3 (``sw_warp_grads``). The kernels walk
the (B, R) fields flat: thread t owns pixels [tP, tP + P) of the B R, counts
their image by stepping past each image's end, reads and writes them by
P-wide vectors when every field and output pointer is 4P-byte aligned, and
by scalars in the last thread's tail past B R and in a call with a
misaligned pointer. The model below copies that mapping (``warp_pixels`` in
csrc/shearwarp.cu; change the two together) and checks that every pixel of
every pose is written exactly once, in its own image, that every vector
access is aligned and inside the fields, that the plan gives every SM a
block at the registration's four shapes, and that the plain versions
evaluated pixel by pixel in the plan's order equal ``_warp_plain`` and
``_warp_with_grads_plain`` (``bf16=False``, the kernels' arithmetic) bit for
bit. Inputs come from ``chip_smoke.warp_edge_inputs``: samples on the
validity bounds and one ulp either side, ws = 0, vc at 0 and Iv - 1.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from xvr_tpu_torch.render import _cuda
from xvr_tpu_torch.render import shearwarp as sw
from torch_threads import two_torch_threads  # noqa: F401

# the plans the launcher takes
PLANS = [(t, p) for p in (1, 2, 4) for t in (64, 128, 256)]
# (B, R) of the registration's shapes (chip_smoke.stage_cases, PERF.md §4):
# the coarse sweep's 16 poses at 60^2, then 4 poses at 60^2, 120^2, 239^2
PATH_SHAPES = {"coarse_B16": (16, 60 * 60), "coarse_B4": (4, 60 * 60), "mid_B4": (4, 120 * 120),
               "fine_B4": (4, 239 * 239)}
# beyond the path: R < 4, R % 4 in {1, 2, 3}, B = 1 and B = 16
EDGE_SHAPES = {"R1": (3, 1), "R2_B1": (1, 2), "R3": (5, 3), "Rmod1": (3, 1001), "Rmod2": (2, 1002),
               "Rmod3": (5, 1003), "B1": (1, 1001), "B16": (16, 999)}
SHAPES = {**PATH_SHAPES, **EDGE_SHAPES}


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_map(B, R, threads, pixels, offset=0, grads=False):
    """The kernels' mapping for a launch of ``threads`` x ``pixels`` on B x R
    pixels whose fields start ``offset`` floats past a 16-byte boundary (the
    outputs are fresh, aligned tensors; K3's three are views of one (3, B, R)
    buffer). -> (blocks, vector path taken, [(pixel o, image b as the kernel
    counts it, the thread's full-vector flag) for each of the P pixels of
    every thread])."""
    N = B * R
    blocks = -(-N // (threads * pixels))
    ptrs = [offset] * 3 + ([0, N, 2 * N] if grads else [0])
    vec = all(q * 4 % (4 * pixels) == 0 for q in ptrs)
    o0 = np.arange(blocks * threads, dtype=np.int64) * pixels
    full = vec & (o0 + pixels <= N)
    b = o0 // R
    b_end = (b + 1) * R
    cols = []
    for p in range(pixels):
        o = o0 + p
        step = o >= b_end
        b, b_end = b + step, b_end + step * R
        cols.append((o, b, full))
    return blocks, vec, cols, ptrs


@pytest.mark.parametrize("grads", [False, True], ids=["K2", "K3"])
@pytest.mark.parametrize("shape", list(PATH_SHAPES))
def test_plan_gives_every_sm_a_block(shape, grads):
    B, R = PATH_SHAPES[shape]
    threads, pixels = _cuda.warp_plan(B, R, grads)
    assert (threads, pixels) in PLANS
    assert -(-B * R // (threads * pixels)) >= _cuda.WARP_SMS


@pytest.mark.parametrize("grads", [False, True], ids=["K2", "K3"])
@pytest.mark.parametrize("sms", [114, 144], ids=["114_SMs", "144_SMs"])
def test_plan_follows_the_sm_count(sms, grads):
    """On a card of another SM count (an H100 PCIe has 114) the plan still
    gives every SM a block at the four path shapes."""
    for B, R in PATH_SHAPES.values():
        threads, pixels = _cuda.warp_plan(B, R, grads, sms)
        assert (threads, pixels) in PLANS
        assert -(-B * R // (threads * pixels)) >= sms


# the plans timed best on the H100 (PERF.md §6): one pixel per thread up to
# the 57,600 pixels of the coarse sweep and the middle stage, in blocks of
# 256 (64 at the 14,400 pixels of a 60^2 pass); two (K2) or four (K3) at the
# fine stage
RULE = {("coarse_B16", False): (256, 1), ("coarse_B4", False): (64, 1),
        ("mid_B4", False): (256, 1), ("fine_B4", False): (256, 2),
        ("coarse_B16", True): (256, 1), ("coarse_B4", True): (64, 1),
        ("mid_B4", True): (256, 1), ("fine_B4", True): (256, 4)}


@pytest.mark.parametrize("shape,grads", list(RULE), ids=[f"{s}-{'K3' if g else 'K2'}" for s, g in RULE])
def test_plan_rule(shape, grads):
    assert _cuda.warp_plan(*PATH_SHAPES[shape], grads) == RULE[shape, grads]


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_every_pixel_written_once(shape, offset):
    """For every plan the launcher takes, K2 and K3: each pixel is written
    once, by a thread that counts its image right; vector accesses are
    aligned, whole and inside the fields; a call with misaligned fields takes
    no vector access; and the plan's own choice is among them."""
    B, R = SHAPES[shape]
    N = B * R
    assert _cuda.warp_plan(B, R, False) in PLANS and _cuda.warp_plan(B, R, True) in PLANS
    for threads, pixels in PLANS:
        for grads in (False, True):
            blocks, vec, cols, ptrs = kernel_map(B, R, threads, pixels, offset, grads)
            assert (blocks - 1) * threads * pixels < N <= blocks * threads * pixels
            assert vec == (offset % pixels == 0 and (not grads or N % pixels == 0))
            written = np.zeros(N, np.int64)
            for o, b, full in cols:
                st = o < N
                np.add.at(written, o[st], 1)
                assert np.array_equal(b[st], o[st] // R)
                assert not (full & ~st).any()  # a full vector lies inside the fields
            assert (written == 1).all()
            o0, _, full = cols[0]
            for q in ptrs:  # every vector access 4P-byte aligned
                assert ((q + o0[full]) * 4 % (4 * pixels) == 0).all()
            if offset % pixels:
                assert not full.any()


def _plain_in_plan_order(I, uc, vc, ws, threads, pixels, grads):
    """The plain version evaluated pixel group by pixel group as the kernel's
    threads take them (image by image within a group position), scattered
    to their flat pixel index."""
    B, R = uc.shape
    N = B * R
    fn = sw._warp_with_grads_plain if grads else sw._warp_plain
    out = torch.full((3 if grads else 1, N), float("nan"), dtype=I.dtype)
    _, _, cols, _ = kernel_map(B, R, threads, pixels)
    for o, b, _ in cols:
        st = o < N
        o, b = o[st], b[st]
        for img in np.unique(b):
            sel = torch.as_tensor(o[b == img])
            r = sel - int(img) * R
            got = fn(I[img:img + 1], uc[img, r][None], vc[img, r][None], ws[img, r][None],
                     bf16=False)
            got = torch.stack(got) if grads else got[None]
            out[:, sel] = got.reshape(out.shape[0], -1)
    return out.reshape(-1, B, R)


PLAIN_CASES = {  # (B, Iu, Iv, R): the path's shapes at a small grid, Iv in {1, 2}, R < 4
    "coarse_B16": (16, 24, 40, 3600), "fine_B4": (4, 24, 40, 239 * 239), "Iv1": (3, 12, 1, 1001),
    "Iv2": (4, 16, 2, 999), "R3": (5, 20, 33, 3), "Rmod2_B1": (1, 20, 33, 1002)}


@pytest.mark.parametrize("case", list(PLAIN_CASES))
def test_plan_order_matches_plain(case):
    B, Iu, Iv, R = PLAIN_CASES[case]
    I, uc, vc, ws = _smoke().warp_edge_inputs(B, Iu, Iv, R, device="cpu")
    ref2 = sw._warp_plain(I, uc, vc, ws, bf16=False)
    ref3 = torch.stack(sw._warp_with_grads_plain(I, uc, vc, ws, bf16=False))
    assert bool((ref2 != 0).any())
    plans = {_cuda.warp_plan(B, R, False), _cuda.warp_plan(B, R, True), (64, 1), (256, 4)}
    for threads, pixels in plans:
        assert torch.equal(_plain_in_plan_order(I, uc, vc, ws, threads, pixels, False)[0], ref2)
        assert torch.equal(_plain_in_plan_order(I, uc, vc, ws, threads, pixels, True), ref3)
