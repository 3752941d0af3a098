"""The content boxes that K1 and K4 skip by, and the operand that carries them
(CPU).

``render.shearwarp._content_boxes`` is the plain version of the content-box
kernel: per slab of a permuted bf16 volume or channel stack, the first and
last row and lane holding a nonzero value. Here it is held against a NumPy
brute force on volumes whose content touches each face, a single voxel, an
empty slab, an empty channel and -0.0 (which is zero). ``tests/test_torch_gpu.py``
holds the kernel to it on the card.
"""

import numpy as np
import pytest
import torch

from xvr_tpu_torch.render import shearwarp as tsw
from torch_threads import two_torch_threads  # noqa: F401


def _brute(vol: np.ndarray) -> np.ndarray:
    """(C, M, Wd, L) float -> (C, M, 4): a loop over the nonzero voxels."""
    C, M, Wd, L = vol.shape
    out = np.empty((C, M, 4), np.int64)
    for c in range(C):
        for k in range(M):
            box = [Wd, -1, L, -1]
            for w in range(Wd):
                for lane in range(L):
                    if vol[c, k, w, lane] != 0.0:
                        box = [min(box[0], w), max(box[1], w), min(box[2], lane), max(box[3], lane)]
            out[c, k] = box
    return out


def _case(name: str) -> np.ndarray:
    """A (C, M, Wd, L) volume for the case ``name``."""
    rng = np.random.default_rng(7)
    C, M, Wd, L = 2, 6, 9, 13
    vol = np.zeros((C, M, Wd, L), np.float32)
    if name == "blob":
        vol[:, 1:5, 2:7, 3:10] = rng.uniform(0.1, 1.0, (C, 4, 5, 7))
    elif name.startswith("face_"):
        axis, end = name[5:-2], name[-1]  # face_<axis>_<0|1>
        sl = [slice(None), slice(2, 4), slice(3, 6), slice(4, 9)]
        a = {"slab": 1, "row": 2, "lane": 3}[axis]
        n = vol.shape[a]
        sl[a] = slice(0, 2) if end == "0" else slice(n - 2, n)
        vol[tuple(sl)] = 1.0
    elif name == "single_voxel":
        vol[1, 3, 4, 7] = 0.5
    elif name == "empty_slab":
        vol[:] = rng.uniform(0.1, 1.0, vol.shape)
        vol[:, 2] = 0.0
    elif name == "empty_channel":
        vol[0] = rng.uniform(0.1, 1.0, vol.shape[1:])
    elif name == "negative_zero":
        vol[:] = -0.0
        vol[0, 1, 5, 2] = 2.0
        vol[1, 4, 0, 12] = -1.0  # a negative value is content
    elif name == "sparse_random":
        vol[:] = rng.uniform(0.1, 1.0, vol.shape) * (rng.uniform(size=vol.shape) < 0.02)
    return vol


CASES = ["blob", "single_voxel", "empty_slab", "empty_channel", "negative_zero", "sparse_random"] + [
    f"face_{a}_{e}" for a in ("slab", "row", "lane") for e in "01"]


@pytest.mark.parametrize("name", CASES)
def test_content_boxes_match_brute_force(name):
    vol = _case(name)
    got = tsw._content_boxes(torch.as_tensor(vol).to(torch.bfloat16))
    assert got.dtype == torch.int32 and tuple(got.shape) == vol.shape[:2] + (4,)
    np.testing.assert_array_equal(got.numpy(), _brute(vol))


def test_content_boxes_of_a_volume_have_one_channel():
    vol = _case("blob")[1]
    got = tsw.content_boxes(torch.as_tensor(vol).to(torch.bfloat16))
    np.testing.assert_array_equal(got.numpy(), _brute(vol[None]))


def test_empty_slabs_get_a_box_that_no_tile_meets():
    vol = torch.zeros((3, 4, 5), dtype=torch.bfloat16)
    vol[1, 2, 3] = -0.0
    assert tsw._content_boxes(vol)[0].tolist() == [[4, -1, 5, -1]] * 3


def test_operand_carries_the_boxes():
    """``as_operand`` gives a bare volume its boxes and keeps an operand;
    its buffer copies take both tensors."""
    vol = torch.as_tensor(_case("blob")).to(torch.bfloat16)
    op = tsw.as_operand(vol)
    assert op.vol is vol and torch.equal(op.boxes, tsw._content_boxes(vol))
    assert tsw.as_operand(op) is op
    buf = op.empty_like()
    assert buf.copy_(op) is buf and torch.equal(buf.vol, vol) and torch.equal(buf.boxes, op.boxes)
    moved = op.to("cpu")
    assert torch.equal(moved.vol, vol) and torch.equal(moved.boxes, op.boxes)
