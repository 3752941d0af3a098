"""Parity of the PyTorch shear-warp renderer with the JAX package (CPU).

Every kernel of the registration path (K1 accumulate, K2 warp, K3 warp
partials, K4 source adjoint) has a plain PyTorch version that runs on CPU
tensors. Here each one is held against the JAX package's oracles on the same
NumPy inputs: the XLA scans and the Pallas kernels in interpret mode (run as
the JAX package's own tests run them), and the whole fast render and its
pose gradient against ``xvr_tpu.render.shearwarp.raymarch_trilinear_fast``.

Tolerances come from the JAX package's own bf16 paths, not from f32
round-off: its two accumulate implementations agree to rtol 2e-2 /
atol 2e-3 * max and its two adjoints to rtol 3e-2 / atol 3e-3 * max
(tests/test_shearwarp.py). The JAX warp reads the slope image as bf16 pairs
while the port reads it in f32, so warp values agree to bf16 rounding
(relative 2^-8 of the image's range).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvr_tpu.geometry import Detector as JDetector, convert as jconvert
from xvr_tpu.render import shearwarp as jsw
from xvr_tpu.render.pallas import choose_permutation_for_pose as j_choose_perm
from xvr_tpu_torch.geometry import Detector, convert
from xvr_tpu_torch.render import shearwarp as tsw
from xvr_tpu_torch.render.layout import choose_permutation_for_pose

N = 40
H = 64


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    g = np.linspace(-1, 1, N)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    blob = np.exp(-((X * 1.2) ** 2 + (Y * 0.8) ** 2 + (Z * 1.1) ** 2) * 6.0)
    density = ((blob * 800.0 + blob * rng.normal(0.0, 40.0, blob.shape)) / 1000.0).astype(np.float32)
    spacing = 2.0
    aff = np.eye(4, dtype=np.float32) * spacing
    aff[3, 3] = 1.0
    aff[:3, 3] = -(N - 1) / 2.0 * spacing
    affinv = np.linalg.inv(aff).astype(np.float32)
    rot = np.array([[2.0, -1.5, 2.5], [0.0, 0.0, 0.0], [-2.5, 1.0, -1.5]], np.float32)
    xyz = np.array([[5.0, 600.0, -8.0], [0.0, 650.0, 0.0], [-6.0, 550.0, 4.0]], np.float32)
    perm = choose_permutation_for_pose(np.eye(3), affinv)
    assert perm == j_choose_perm(np.eye(3), affinv)
    return dict(density=density, affinv=affinv, rot=rot, xyz=xyz, perm=perm)


def _rays_both(s):
    jdet = JDetector(sdd=1020.0, height=H, width=H, delx=1.5, dely=1.5)
    tdet = Detector(sdd=1020.0, height=H, width=H, delx=1.5, dely=1.5)
    jpose = jconvert(jnp.asarray(s["rot"]), jnp.asarray(s["xyz"]), "euler_angles", "ZXY", degrees=True)
    tpose = convert(_t(s["rot"]), _t(s["xyz"]), "euler_angles", "ZXY", degrees=True)
    return jdet.rays(jpose), tdet.rays(tpose)


def _slab_inputs(seed, sgnval, B=5, M=16, Wd=10, L=20):
    rng = np.random.default_rng(seed)
    vol = rng.normal(0.5, 0.3, (M, Wd, L)).astype(np.float32)
    s_p = (rng.normal(0.0, 2.0, (B, 3)) + np.array([-8.0, 5.0, 10.0])).astype(np.float32)
    sgn = np.full((B,), sgnval, np.float32)
    u0 = rng.normal(-0.5, 0.1, B).astype(np.float32)
    du = rng.uniform(0.02, 0.08, B).astype(np.float32)
    v0 = rng.normal(-0.8, 0.1, B).astype(np.float32)
    dv = rng.uniform(0.02, 0.05, B).astype(np.float32)
    return vol, s_p, sgn, u0, du, v0, dv


def _both(args):
    vol, *rest = args
    jargs = [jnp.asarray(vol).astype(jnp.bfloat16)] + [jnp.asarray(a) for a in rest]
    targs = [_t(vol).to(torch.bfloat16)] + [_t(a) for a in rest]
    return jargs, targs


ACC_CASES = [
    (1.0, 0, None, 1.0),
    (0.25, 0, None, 1.0),
    (1.0, 4, 12, -1.0),
    (0.25, 2, 14, -1.0),
]


@pytest.mark.parametrize("eps,k0,k1,sgnval", ACC_CASES)
def test_accumulate_plain_matches_jax(eps, k0, k1, sgnval):
    """K1's plain version against the XLA scan and the Pallas kernel
    (interpret mode); tolerance of the JAX package's own two bf16 paths."""
    Iu, Iv = 16, 128
    jargs, targs = _both(_slab_inputs(3, sgnval))
    kw = dict(Iu=Iu, Iv=Iv, eps=eps, k0=k0, k1=k1)
    got = tsw.accumulate(*targs, **kw).numpy()
    for ref in (
        np.asarray(jsw._accumulate(*jargs, unroll=4, **kw)),
        np.asarray(jsw._accumulate_fused(*jargs, unroll=4, interpret=True, **kw)),
    ):
        scale = max(np.abs(ref).max(), 1e-6)
        np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-3 * scale)


@pytest.mark.parametrize("eps,k0,k1,sgnval", ACC_CASES)
def test_accumulate_adjoint_plain_matches_jax(eps, k0, k1, sgnval):
    """K4's plain version (contracted to g_s) against the XLA adjoint scan
    and the Pallas adjoint (interpret mode); the JAX adjoints' tolerance."""
    Iu, Iv = 16, 128
    args = _slab_inputs(7, sgnval)
    ibar = np.random.default_rng(8).normal(0.0, 1.0, (5, Iu, Iv)).astype(np.float32)
    jargs, targs = _both(args)
    kw = dict(Iu=Iu, Iv=Iv, eps=eps, k0=k0, k1=k1)
    got = tsw.accumulate_adjoint(*targs, _t(ibar), **kw).numpy()
    for ref in (
        np.asarray(jsw._accumulate_adjoint(*jargs, jnp.asarray(ibar), unroll=4, **kw)),
        np.asarray(jsw._accumulate_adjoint_fused(*jargs, jnp.asarray(ibar), unroll=4,
                                                 interpret=True, **kw)),
    ):
        scale = max(np.abs(ref).max(), 1e-6)
        np.testing.assert_allclose(got, ref, rtol=3e-2, atol=3e-3 * scale)


def _warp_inputs(seed, B=3, Iu=16, Iv=128, Hd=12, Wdet=20):
    rng = np.random.default_rng(seed)
    I = rng.uniform(0.0, 1.0, (B, Iu, Iv)).astype(np.float32)
    # coordinates reach past every edge so the validity mask is exercised
    uc = rng.uniform(-2.0, Iu + 1.0, (B, Hd * Wdet)).astype(np.float32)
    vc = rng.uniform(-1.5, Iv + 0.5, (B, Hd * Wdet)).astype(np.float32)
    ws = rng.uniform(-0.2, 2.0, (B, Hd * Wdet)).astype(np.float32)
    return I, uc, vc, ws, (Iu, Iv), (Hd, Wdet)


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_plain_matches_jax(seed):
    """K2's plain version against the Pallas warp (interpret mode, window =
    Iu so the JAX side clips nothing); bf16 rounding of the JAX table."""
    I, uc, vc, ws, grid, det = _warp_inputs(seed)
    ref = np.asarray(jsw._warp(
        jnp.asarray(I), jnp.asarray(uc), jnp.asarray(vc), jnp.asarray(ws),
        det_shape=det, grid_shape=grid, window=grid[0], interpret=True,
    ))
    got = tsw.warp(_t(I), _t(uc), _t(vc), _t(ws)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-2, atol=4e-3 * np.abs(ws).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_with_grads_plain_matches_jax(seed):
    """K3's plain version: value and both partials against the Pallas
    kernel (interpret mode, window = Iu)."""
    I, uc, vc, ws, grid, det = _warp_inputs(seed)
    refs = jsw._warp_with_grads(
        jnp.asarray(I), jnp.asarray(uc), jnp.asarray(vc), jnp.asarray(ws),
        det_shape=det, grid_shape=grid, window=grid[0], interpret=True,
    )
    gots = tsw.warp_with_grads(_t(I), _t(uc), _t(vc), _t(ws))
    for got, ref in zip(gots, refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-2, atol=8e-3)


def test_warp_transpose_matches_jax():
    """The bilinear scatter-add against the JAX dense hat-matrix transpose
    (bf16 hat factors on the JAX side)."""
    I, uc, vc, ws, grid, det = _warp_inputs(5)
    gw = np.random.default_rng(6).normal(0.0, 1.0, uc.shape).astype(np.float32)
    ref = np.asarray(jsw._warp_transpose(jnp.asarray(gw), jnp.asarray(uc), jnp.asarray(vc),
                                         grid_shape=grid, det_shape=det))
    got = tsw._warp_transpose(_t(gw), _t(uc), _t(vc), grid_shape=grid).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-3 * np.abs(ref).max())


@pytest.mark.parametrize("eps", [1.0, 0.25])
def test_fast_forward_matches_jax(scene, eps):
    """The whole fast render (accumulate + warp) against the JAX fast path
    with an unclipped warp window."""
    (jsrc, jtgt), (tsrc, ttgt) = _rays_both(scene)
    grid = jsw.default_grid_shape((H, H))
    assert grid == tsw.default_grid_shape((H, H))
    ref = np.asarray(jsw.raymarch_trilinear_fast(
        jnp.asarray(scene["density"]), jnp.asarray(scene["affinv"]), jsrc, jtgt,
        perm=scene["perm"], warp_window=grid[0], eps=eps,
    ))
    got = tsw.raymarch_trilinear_fast(
        _t(scene["density"]), _t(scene["affinv"]), tsrc, ttgt, perm=scene["perm"], eps=eps,
    ).detach().numpy()
    fwd_only = tsw.raymarch_trilinear_shearwarp(
        _t(scene["density"]), _t(scene["affinv"]), tsrc, ttgt, perm=scene["perm"], eps=eps,
    ).numpy()
    np.testing.assert_array_equal(fwd_only, got)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-3 * scale)


@pytest.mark.parametrize("eps", [1.0, 0.25])
@pytest.mark.parametrize("r0", [
    [2.2, -1.3, 2.7, 4.0, 610.0, -7.0],
    [1.0, -2.5, 3.5, 7.0, 590.0, -4.0],
])
def test_fast_pose_gradient_matches_jax(scene, eps, r0):
    """d(loss)/d(pose) through convert -> rays -> fast render (the analytic
    adjoint backward) against jax.grad of the same loss, the registration-
    style loss of tests/test_shearwarp.py (squared error to a golden render
    at a nearby pose): cosine > 0.999 and norms within 3%.

    The rotation components are the sensitive ones: the JAX warp reads the
    slope image as bf16, which moves them by up to ~100 (of ~5000) on this
    scene; the port reads f32 and lands nearer the golden gradient."""
    from xvr_tpu.render import xla as jxla

    jdet = JDetector(sdd=1020.0, height=H, width=H, delx=1.5, dely=1.5)
    tdet = Detector(sdd=1020.0, height=H, width=H, delx=1.5, dely=1.5)
    grid = jsw.default_grid_shape((H, H))
    dens_j, aff_j = jnp.asarray(scene["density"]), jnp.asarray(scene["affinv"])
    p_ref = jconvert(jnp.asarray(scene["rot"][:1]), jnp.asarray(scene["xyz"][:1]),
                     "euler_angles", "ZXY", degrees=True)
    ref = np.asarray(jxla.raymarch_trilinear(dens_j, aff_j, *jdet.rays(p_ref), n_samples=512))

    def jloss(r6):
        p = jconvert(r6[None, :3], r6[None, 3:], "euler_angles", "ZXY", degrees=True)
        img = jsw.raymarch_trilinear_fast(dens_j, aff_j, *jdet.rays(p), perm=scene["perm"],
                                          warp_window=grid[0], eps=eps)
        return jnp.sum((img - jnp.asarray(ref)) ** 2)

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(r0, jnp.float32)))

    r6 = torch.tensor(r0, dtype=torch.float32, requires_grad=True)
    p = convert(r6[None, :3], r6[None, 3:], "euler_angles", "ZXY", degrees=True)
    img = tsw.raymarch_trilinear_fast(_t(scene["density"]), _t(scene["affinv"]), *tdet.rays(p),
                                      perm=scene["perm"], eps=eps)
    ((img - _t(ref)) ** 2).sum().backward()
    tg = r6.grad.numpy()

    cos = float(np.dot(jg, tg) / (np.linalg.norm(jg) * np.linalg.norm(tg)))
    ratio = float(np.linalg.norm(tg) / np.linalg.norm(jg))
    assert cos > 0.999, (cos, jg, tg)
    assert abs(ratio - 1.0) < 0.03, (ratio, jg, tg)


def test_fast_slab_backward_matches_jax(scene):
    """backward="slab" (the shear-warp forward with the slab kernel's VJP,
    K6 on its plain version) against the JAX package's (its _kernel_bwd in
    interpret mode, a slab window of the whole volume): the same float32
    arithmetic on the same bf16 table, to atol 1e-4 * max."""
    (jsrc, jtgt), (tsrc, ttgt) = _rays_both(scene)
    jsrc, jtgt, tsrc, ttgt = jsrc[:1], jtgt[:1], tsrc[:1], ttgt[:1]
    w = np.random.default_rng(4).normal(size=(1, H * H)).astype(np.float32)
    dens_j, aff_j = jnp.asarray(scene["density"]), jnp.asarray(scene["affinv"])

    def jloss(t):
        img = jsw.raymarch_trilinear_fast(dens_j, aff_j, jsrc, t, perm=scene["perm"],
                                          warp_window=128, slab_window=N, backward="slab")
        return jnp.sum(img * w)

    jg = np.asarray(jax.grad(jloss)(jtgt))
    tgt = ttgt.detach().clone().requires_grad_(True)
    img = tsw.raymarch_trilinear_fast(_t(scene["density"]), _t(scene["affinv"]), tsrc, tgt,
                                      perm=scene["perm"], backward="slab")
    (img * _t(w)).sum().backward()
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(tgt.grad.numpy(), jg, rtol=1e-4, atol=1e-4 * np.abs(jg).max())


def test_unported_options_raise(scene):
    (_, _), (tsrc, ttgt) = _rays_both(scene)
    args = (_t(scene["density"]), _t(scene["affinv"]), tsrc, ttgt)
    with pytest.raises(ValueError, match="unknown backward"):
        tsw.raymarch_trilinear_fast(*args, perm=scene["perm"], backward="scan")
    # label channels are ported (tests/test_torch_channels.py); only the slab
    # backward refuses them, as the JAX package's does
    chans = tsw.raymarch_trilinear_fast(*args, perm=scene["perm"],
                                        mask=torch.ones(N, N, N, dtype=torch.int32), labels=(1,))
    assert tuple(chans.shape) == (ttgt.shape[0], 2, ttgt.shape[1])
    with pytest.raises(ValueError, match="channel"):
        tsw.raymarch_trilinear_fast(*args, perm=scene["perm"], backward="slab",
                                    mask=torch.ones(N, N, N, dtype=torch.int32), labels=(1,))
    # grid_bounds is ported (tests/test_torch_parallel.py): the bounds of the
    # rays' own fit give the render without them, bit for bit
    side = int(round(ttgt.shape[1] ** 0.5))
    bounds = tsw.shearwarp_grid_bounds(args[1], tsrc, ttgt, perm=scene["perm"],
                                       grid_shape=tsw.default_grid_shape((side, side)))
    assert all(b.shape == (ttgt.shape[0],) and not b.requires_grad for b in bounds)
    torch.testing.assert_close(
        tsw.raymarch_trilinear_fast(*args, perm=scene["perm"], grid_bounds=bounds),
        tsw.raymarch_trilinear_fast(*args, perm=scene["perm"]), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# A float64 model of the tiled K1/K4 march of csrc/shearwarp.cu, step by step:
# tiles, the per-slab block-uniform skips from the tile's corner positions,
# the staged box of rows and lanes in chunks, the lane pass and the row pass.
# It must equal the dense plain versions, so the kernels' plan drops nothing.
# ---------------------------------------------------------------------------

# the kernels' constants: a (TI, TJ) tile of the slope grid per block, staged
# chunks of at most (STAGE_ELEMS bf16, STAGE_ROWS rows)
SW_TILE = (16, 64)
SW_STAGE = (2048, 32)


def stage_rows(n_lanes: int, stage: tuple[int, int] = SW_STAGE) -> int:
    """Rows of one chunk of a box whose rows hold ``n_lanes`` lanes, as the
    kernels choose it: ``min(rows, elements // n_lanes)``, or ``rows`` for a
    box too wide to stage, which the lane pass reads from global memory."""
    elems, rows = stage
    return rows if n_lanes > elems else min(rows, elems // n_lanes)


def _tiled_model(vol, s_p, sgn, u0, du, v0, dv, Ibar=None, *, Iu, Iv, eps, k0=0, k1=None,
                 tile=SW_TILE, stage=SW_STAGE):
    """-> (I (B, Iu, Iv), stats) without ``Ibar``, else ((gw, gl), stats);
    stats count what the plan met: chunks per slab, skipped slabs, valid
    samples at floor(wpos) = -1 and Wd - 1, samples with one axis out, boxes
    too wide to stage."""
    M, Wd, L = vol.shape
    k1 = M if k1 is None else k1
    TI, TJ = tile
    f = torch.float64
    S_all = vol.to(f)
    B = s_p.shape[0]
    adj = Ibar is not None
    hat = lambda x: tsw._hat(x, eps)  # noqa: E731
    hatp = lambda x: tsw._hat_prime(x, eps)  # noqa: E731
    out = torch.zeros((B, Iu, Iv), dtype=f)
    gw, gl = torch.zeros((B, Iu), dtype=f), torch.zeros((B, Iv), dtype=f)
    stats = dict(max_chunks=0, skipped=0, w_first=0, w_last=0, one_axis=0, unstaged=0)
    for b in range(B):
        s0, s1, s2 = (s_p[b, a].item() for a in range(3))
        for i0 in range(0, Iu, TI):
            u = u0[b] + du[b] * torch.arange(i0, min(i0 + TI, Iu), dtype=f)
            for j0 in range(0, Iv, TJ):
                v = v0[b] + dv[b] * torch.arange(j0, min(j0 + TJ, Iv), dtype=f)
                if adj:
                    ib = Ibar[b, i0:i0 + TI, j0:j0 + TJ].to(torch.bfloat16).to(f)
                    if not bool((ib != 0).any()):
                        continue
                acc_a = torch.zeros((len(u), len(v)), dtype=f)
                acc_b = torch.zeros_like(acc_a)
                for k in range(k0, k1):
                    c = float(k) - s0
                    wk = min(max(sgn[b].item() * c + 0.5, 0.0), 1.0)
                    wpos, lpos = s1 + c * u, s2 + c * v
                    wf, lf = torch.floor(wpos), torch.floor(lpos)
                    # the plan: the tile's range from its corner rows and columns
                    wmin, wmax = (np.floor(g(wpos[0].item(), wpos[-1].item())) for g in (min, max))
                    lmin, lmax = (np.floor(g(lpos[0].item(), lpos[-1].item())) for g in (min, max))
                    assert wmin <= wf.min() and wf.max() <= wmax
                    assert lmin <= lf.min() and lf.max() <= lmax
                    if wk == 0.0 or wmax < -1 or wmin >= Wd or lmax < -1 or lmin >= L:
                        stats["skipped"] += 1
                        continue
                    wlo, whi = int(max(wmin, 0)), int(min(wmax + 1, Wd - 1))
                    la, lhi = int(max(lmin, 0)) & ~1, int(min(lmax + 1, L - 1))
                    npad = (lhi - la + 2) & ~1
                    rpc = stage_rows(npad, stage)
                    stats["unstaged"] += npad > stage[0]
                    # per-column and per-row flags and hats
                    lok = (lf >= -1) & (lf < L)
                    wok = (wf >= -1) & (wf < Wd)
                    fl, fw = lpos - lf, wpos - wf
                    hl0, hl1 = hat(fl) * lok, hat(fl - 1.0) * lok
                    hp0, hp1 = hatp(fl) * lok, hatp(fl - 1.0) * lok
                    hw0, hw1 = hat(fw) * wok, hat(fw - 1.0) * wok
                    hwp0, hwp1 = hatp(fw) * wok, hatp(fw - 1.0) * wok
                    l0, w0 = lf.to(torch.int64), wf.to(torch.int64)
                    stats["w_first"] += int((wok & (w0 == -1)).sum()) * int(lok.sum())
                    stats["w_last"] += int((wok & (w0 == Wd - 1)).sum()) * int(lok.sum())
                    stats["one_axis"] += int(wok.sum()) * int((~lok).sum()) + int((~wok).sum()) * int(lok.sum())
                    chunks = range(wlo, whi + 1, rpc)
                    stats["max_chunks"] = max(stats["max_chunks"], len(chunks))
                    for wc in chunks:
                        nr = min(rpc, whi - wc + 1)
                        box = torch.zeros((nr, npad), dtype=f)
                        n = min(npad, L - la)
                        box[:, :n] = S_all[k, wc:wc + nr, la:la + n]
                        # lane pass: lanes -1 and L read as zero
                        ia, ibb = l0 - la, l0 + 1 - la
                        sa = box[:, ia.clamp(0, npad - 1)] * ((l0 >= 0) & lok)
                        sb = box[:, ibb.clamp(0, npad - 1)] * ((l0 + 1 < L) & lok)
                        T, Tp = hl0 * sa + hl1 * sb, hp0 * sa + hp1 * sb  # (nr, nj)
                        # row pass: taps outside this chunk's rows add nothing
                        r0 = w0 - wc
                        in0 = ((r0 >= 0) & (r0 < nr) & wok)[:, None]
                        in1 = ((r0 + 1 >= 0) & (r0 + 1 < nr) & wok)[:, None]
                        t0, t1 = T[r0.clamp(0, nr - 1)] * in0, T[(r0 + 1).clamp(0, nr - 1)] * in1
                        if adj:
                            p0 = Tp[r0.clamp(0, nr - 1)] * in0
                            p1 = Tp[(r0 + 1).clamp(0, nr - 1)] * in1
                            acc_a += wk * (hwp0[:, None] * t0 + hwp1[:, None] * t1)
                            acc_b += wk * (hw0[:, None] * p0 + hw1[:, None] * p1)
                        else:
                            acc_a += wk * (hw0[:, None] * t0 + hw1[:, None] * t1)
                rows, cols = slice(i0, i0 + len(u)), slice(j0, j0 + len(v))
                if adj:
                    gw[b, rows] += (acc_a * ib).sum(1)
                    gl[b, cols] += (acc_b * ib).sum(0)
                else:
                    out[b, rows, cols] = acc_a
    return ((gw, gl) if adj else out), stats


# (name, geometry overrides, stage, what the plan must meet)
MODEL_CASES = [
    ("bench_like", dict(), SW_STAGE, ()),
    ("eps_quarter", dict(eps=0.25), SW_STAGE, ()),
    ("reverse_subrange", dict(sgnval=-1.0, s0=20.0, k0=3, k1=13), SW_STAGE, ()),
    ("reverse_subrange_eps_quarter", dict(sgnval=-1.0, s0=20.0, k0=5, k1=16, eps=0.25),
     SW_STAGE, ()),
    ("source_inside", dict(s0=5.3), SW_STAGE, ("skipped",)),
    ("steep_rows", dict(Wd=96, s1=48.0, u0=-2.5, du=0.25, Iu=40), SW_STAGE,
     ("max_chunks", "w_first", "w_last", "one_axis", "skipped")),
    ("steep_both_small_stage", dict(u0=-1.0, du=0.12, dv=0.09, Iu=20, Iv=70, v0=-3.0), (64, 32),
     ("max_chunks", "w_first", "w_last", "one_axis")),
    ("steep_eps_quarter", dict(Wd=96, s1=48.0, u0=-2.5, du=0.25, eps=0.25, sgnval=-1.0, s0=20.0),
     SW_STAGE, ("max_chunks", "one_axis")),
    ("whole_tiles", dict(Iu=32, Iv=128), SW_STAGE, ()),
    # whole tiles whose rows sit at floor(wpos) = -1 (lanes at L - 1), or at Wd - 1
    ("edge_tile_low", dict(s1=-0.5, u0=0.0, du=0.001, s2=29.5, v0=0.0, dv=0.001), SW_STAGE,
     ("w_first",)),
    ("edge_tile_high", dict(s1=23.5, u0=0.0, du=0.001, eps=0.25), SW_STAGE, ("w_last",)),
    ("odd_lanes_many_tiles", dict(L=31, Iu=40, Iv=150, dv=0.008), SW_STAGE, ()),
    # boxes wider than a chunk: read from global memory, rows still chunked
    ("wide_lanes_unstaged", dict(Wd=40, s1=20.0, L=90, s2=45.0, v0=-3.0, dv=0.09, Iv=70),
     (64, 4), ("unstaged", "max_chunks", "one_axis")),
]


def _model_inputs(seed, sgnval=1.0, eps=1.0, B=2, M=16, Wd=24, L=30, Iu=20, Iv=40, s0=-8.0,
                  s1=12.0, s2=15.0, u0=-0.45, du=0.045, v0=-0.5, dv=0.025, k0=0, k1=None):
    rng = np.random.default_rng(seed)
    vol = torch.as_tensor(rng.uniform(0.0, 1.0, (M, Wd, L))).to(torch.bfloat16)
    s_p = torch.as_tensor(np.array([s0, s1, s2]) + rng.normal(0.0, 0.3, (B, 3)))
    jit = lambda x: torch.as_tensor(x * (1.0 + rng.uniform(-0.05, 0.05, B)))  # noqa: E731
    args = (s_p, torch.full((B,), sgnval, dtype=torch.float64), jit(u0), jit(du), jit(v0), jit(dv))
    return vol, args, dict(Iu=Iu, Iv=Iv, eps=eps, k0=k0, k1=k1)


def _check_stats(stats, expect):
    for key in expect:
        assert stats[key] > (1 if key == "max_chunks" else 0), (key, stats)


@pytest.mark.parametrize("name,geo,stage,expect", MODEL_CASES, ids=[c[0] for c in MODEL_CASES])
def test_tiled_accumulate_model_matches_plain(name, geo, stage, expect):
    """K1's tiled schedule (float64 model) equals the dense plain version."""
    vol, args, kw = _model_inputs(11, **geo)
    got, stats = _tiled_model(vol, *args, stage=stage, **kw)
    ref = tsw._accumulate(vol, *args, bf16=False, **kw)
    _check_stats(stats, expect)
    assert float(ref.abs().max()) > 0
    torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-10 * float(ref.abs().max()))


@pytest.mark.parametrize("name,geo,stage,expect", MODEL_CASES, ids=[c[0] for c in MODEL_CASES])
def test_tiled_adjoint_model_matches_plain(name, geo, stage, expect):
    """K4's tiled schedule (float64 model, per-row sums gw and gl) equals the
    dense plain version; an all-zero tile of Ibar is skipped."""
    vol, args, kw = _model_inputs(12, **geo)
    B = args[0].shape[0]
    ibar = torch.as_tensor(np.random.default_rng(13).normal(0.0, 1.0, (B, kw["Iu"], kw["Iv"])))
    TI, TJ = SW_TILE
    ibar[:, :TI, TJ:2 * TJ] = 0.0  # a tile outside the view, where there are several
    (gw, gl), stats = _tiled_model(vol, *args, ibar, stage=stage, **kw)
    rw, rl = tsw._adjoint_rows(vol, *args, ibar, bf16=False, **kw)
    _check_stats(stats, expect)
    for got, ref in ((gw, rw), (gl, rl)):
        assert float(ref.abs().max()) > 0
        torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-10 * float(ref.abs().max()))


def test_stage_rows_rule():
    assert stage_rows(36) == SW_STAGE[1]
    assert stage_rows(258) == SW_STAGE[0] // 258
    assert stage_rows(30, (64, 32)) == 2
    assert stage_rows(SW_STAGE[0]) == 1
    assert stage_rows(SW_STAGE[0] + 2) == SW_STAGE[1]  # unstaged
