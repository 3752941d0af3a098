"""The port's training pieces against the JAX package's (CPU).

Each piece gets the same inputs in both packages (from a NumPy seed, or the
JAX package's own random draws handed to the port's deterministic bodies):
the pose sampler, every augmentation op and the whole pipeline, the Dice
metric, the composite loss (with and without the multiview term, with
``keep`` weights), the learning-rate schedules at every step, and the
hand-written AGC-Adam-MultiSteps optimizer against optax over 8 updates on a
ResNet-18 parameter tree.

Tolerances: poses and the photometric ops to float32 round-off (rtol 1e-5);
CLAHE to one bf16 step of its CDFs (2^-8: both packages read the tile CDFs
in bf16, and a CDF near a bf16 rounding boundary may round either way);
losses to rtol 1e-5; schedules to rtol 1e-6 (optax evaluates them in
float32); the optimizer's parameters and state leaves to rtol 1e-6 with
atol 1e-6 of each leaf's largest magnitude (moments that cancel to ~0).
"""

import math

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from xvr_tpu.geometry import convert as jconvert
from xvr_tpu.metrics import dice as jdice
from xvr_tpu.train import augmentations as jaug
from xvr_tpu.train import get_random_pose as j_get_random_pose
from xvr_tpu.train import pose_regression_loss as j_loss
from xvr_tpu.train.schedule import identity_schedule as j_identity
from xvr_tpu.train.schedule import warmup_cosine_schedule as j_warmup_cosine
from xvr_tpu_torch.geometry import convert
from xvr_tpu_torch.metrics import dice_coefficient, dice_loss
from xvr_tpu_torch.models import PoseRegressor
from xvr_tpu_torch.state import from_flax_params, to_flax_params
from xvr_tpu_torch.train import augmentations as taug
from xvr_tpu_torch.train import (
    AGCAdamMultiSteps,
    identity_schedule,
    pose_regression_loss,
    warmup_cosine_schedule,
)
from xvr_tpu_torch.train.optim import agc_axes
from xvr_tpu_torch.train.sampler import RANGE_KEYS, get_random_pose, pose_from_uniforms


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two torch threads per test: the suite runs several workers on one
    machine, and each worker's torch would otherwise start a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


RANGES = dict(
    alphamin=165.0, alphamax=195.0, betamin=-15.0, betamax=15.0,
    gammamin=-15.0, gammamax=15.0, txmin=-10.0, txmax=10.0,
    tymin=150.0, tymax=250.0, tzmin=-10.0, tzmax=10.0,
)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ranges", [
    RANGES,
    dict(RANGES, alphamin=75.0, alphamax=270.0),  # wraps past 180
    dict(RANGES, alphamin=-45.0, alphamax=105.0, betamin=-40.0, betamax=40.0),
])
def test_sampler_matches_jax_on_equal_uniforms(ranges):
    """The JAX sampler's own uniforms, drawn key by key as it draws them,
    give the same poses in the port."""
    key, B = jax.random.PRNGKey(7), 32
    jpose = j_get_random_pose(key, batch_size=B, **ranges)
    keys = jax.random.split(key, 6)
    u = np.stack([np.asarray(jax.random.uniform(k, (B,))) for k in keys], axis=1)
    tpose = pose_from_uniforms(_t(u), **ranges)
    np.testing.assert_allclose(tpose.matrix.numpy(), np.asarray(jpose.matrix), rtol=1e-5, atol=1e-4)


def test_sampler_ranges_and_wrap():
    gen = torch.Generator().manual_seed(0)
    ranges = dict(RANGES, alphamin=170.0, alphamax=190.0, betamin=0.0, betamax=0.0,
                  gammamin=0.0, gammamax=0.0)
    pose = get_random_pose(gen, batch_size=256, **ranges)
    rot, xyz = pose.convert("euler_angles", "ZXY", degrees=True)
    a = rot[:, 0].numpy()
    assert ((a > -180.0) & (a <= 180.0)).all()
    assert (np.abs(a) >= 169.5).all()  # wrapped: near +-180, none in the middle
    assert (xyz[:, 1].numpy() >= 149.5).all() and (xyz[:, 1].numpy() <= 250.5).all()
    assert RANGE_KEYS == ("alpha", "beta", "gamma", "tx", "ty", "tz")
    # the generator alone fixes the draws
    again = get_random_pose(torch.Generator().manual_seed(0), batch_size=256, **ranges)
    assert torch.equal(again.matrix, pose.matrix)


# ---------------------------------------------------------------------------
# augmentations
# ---------------------------------------------------------------------------


def _images(shape=(3, 1, 32, 32), seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=shape).astype(np.float32)


def jax_aug_draws(key, shape, p, max_crop=10) -> dict:
    """The draws of ``xvr_tpu.train.augmentations.xray_augmentations`` for
    ``key``, key by key as it makes them, in the port's layout."""
    B, _, H, W = shape
    k = jax.random.split(key, 16)
    ks, kr, ky, kx = jax.random.split(k[10], 4)

    def take(kk):
        return np.asarray(jax.random.bernoulli(kk, p, (B,)))

    def uni(kk, lo=0.0, hi=1.0):
        return np.asarray(jax.random.uniform(kk, (B,), minval=lo, maxval=hi))

    d = dict(
        clip=uni(k[0], 1.0, 10.0), take_clahe=take(k[1]),
        gamma=uni(k[2], 0.7, 1.8), take_gamma=take(k[3]),
        take_blur=take(k[4]),
        noise=np.asarray(0.01 * jax.random.normal(k[5], shape, dtype=jnp.float32)),
        take_noise=take(k[6]),
        factor=uni(k[7], 0.0, 0.5), take_sharp=take(k[8]),
        take_erase=take(k[9]),
        erase_area=np.asarray(jax.random.uniform(ks, (B,), minval=0.02, maxval=0.33) * H * W),
        erase_log_r=uni(kr, math.log(0.3), math.log(3.3)),
        erase_top=uni(ky), erase_left=uni(kx),
        take_crop=take(k[11]),
        crop=np.asarray(jax.random.randint(k[12], (B,), 0, max_crop + 1)),
    )
    return {name: _t(v) for name, v in d.items()}


def test_clahe_matches_jax_and_per_pixel_reference():
    """CLAHE at the trainer's image size and at sizes that need the reflect
    pad, against the JAX package's; and against the per-pixel gather
    reference of tests/test_train.py (its tolerance, 0.02)."""
    rng = np.random.default_rng(1)
    for shape in [(3, 1, 64, 64), (2, 1, 128, 128), (2, 1, 36, 40), (2, 1, 20, 20)]:
        x = rng.uniform(size=shape).astype(np.float32)
        clip = rng.uniform(1.0, 10.0, shape[0]).astype(np.float32)
        ref = np.asarray(jaug.clahe(jnp.asarray(x), jnp.asarray(clip)))
        got = taug.clahe(_t(x), _t(clip)).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=2.0**-8)

    x = rng.uniform(size=(2, 1, 64, 64)).astype(np.float32)
    clip = np.asarray([1.5, 6.0])
    grid, n_bins, th = 8, 64, 8
    ref = np.zeros((2, 64, 64))
    for b in range(2):
        img = x[b, 0].astype(np.float64)
        hists = np.zeros((grid, grid, n_bins))
        for gy in range(grid):
            for gx in range(grid):
                tile = img[gy * th:(gy + 1) * th, gx * th:(gx + 1) * th]
                h = np.bincount(np.clip((tile * n_bins).astype(int), 0, n_bins - 1).reshape(-1),
                                minlength=n_bins).astype(np.float64)
                limit = clip[b] * th * th / n_bins
                hists[gy, gx] = np.minimum(h, limit) + np.maximum(h - limit, 0).sum() / n_bins
        cdf = np.cumsum(hists, -1)
        cdf = cdf / cdf[..., -1:]
        yy = (np.arange(64) + 0.5) / th - 0.5
        y0 = np.clip(np.floor(yy).astype(int), 0, grid - 1)
        y1 = np.clip(y0 + 1, 0, grid - 1)
        fy = np.clip(yy - y0, 0, 1)[:, None]
        fx = fy.T
        bins = np.clip((img * n_bins).astype(int), 0, n_bins - 1)

        def lut(ti, tj):
            return cdf[ti[:, None], tj[None, :], bins]

        ref[b] = (lut(y0, y0) * (1 - fy) * (1 - fx) + lut(y0, y1) * (1 - fy) * fx
                  + lut(y1, y0) * fy * (1 - fx) + lut(y1, y1) * fy * fx)
    got = taug.clahe(_t(x), _t(clip, torch.float32)).numpy()[:, 0]
    assert np.abs(got - ref).max() < 0.02


def test_photometric_ops_match_jax():
    """Box blur, sharpness, erasing and the centre crop on equal parameters."""
    x = _images()
    B, _, H, W = x.shape
    np.testing.assert_allclose(taug.box_blur(_t(x)).numpy(), np.asarray(jaug.box_blur(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    f = np.array([0.1, 0.3, 0.5], np.float32)
    np.testing.assert_allclose(taug.sharpness(_t(x), _t(f)).numpy(),
                               np.asarray(jaug.sharpness(jnp.asarray(x), jnp.asarray(f))),
                               rtol=1e-5, atol=1e-6)
    key = jax.random.PRNGKey(3)
    d = jax_aug_draws(jax.random.PRNGKey(5), x.shape, 0.5)
    ks, kr, ky, kx = jax.random.split(key, 4)
    d["erase_area"] = _t(jax.random.uniform(ks, (B,), minval=0.02, maxval=0.33) * H * W)
    d["erase_log_r"] = _t(jax.random.uniform(kr, (B,), minval=math.log(0.3), maxval=math.log(3.3)))
    d["erase_top"], d["erase_left"] = _t(jax.random.uniform(ky, (B,))), _t(jax.random.uniform(kx, (B,)))
    got = taug.random_erasing(_t(x), d["erase_area"], d["erase_log_r"], d["erase_top"],
                              d["erase_left"]).numpy()
    np.testing.assert_array_equal(got, np.asarray(jaug.random_erasing(key, jnp.asarray(x))))
    assert (got == 0).any()
    crop_key = jax.random.PRNGKey(9)
    crop = _t(jax.random.randint(crop_key, (B,), 0, 11))
    np.testing.assert_array_equal(taug.random_center_crop(_t(x), crop).numpy(),
                                  np.asarray(jaug.random_center_crop(crop_key, jnp.asarray(x), 10)))


@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
def test_pipeline_matches_jax_on_equal_draws(p):
    """The whole pipeline (standardize, CLAHE, gamma, blur, noise, sharpness,
    erasing, collimation crop) with the JAX package's draws."""
    x = _images((4, 1, 32, 32), seed=2)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jaug.xray_augmentations(key, jnp.asarray(x), p=p))
    got = taug.apply_augmentations(_t(x), jax_aug_draws(key, x.shape, p)).numpy()
    # CLAHE's one-bf16-step CDF rounding propagates through gamma (< 1.8x)
    # and sharpness (< 1.5x)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=3 * 2.0**-8)
    if p == 0.0:
        np.testing.assert_allclose(got, taug.standardize(_t(x)).numpy(), atol=1e-6)


def test_pipeline_draws_follow_the_generator():
    x = _t(_images((4, 1, 32, 32)))
    a = taug.xray_augmentations(torch.Generator().manual_seed(1), x, p=0.9)
    b = taug.xray_augmentations(torch.Generator().manual_seed(1), x, p=0.9)
    c = taug.xray_augmentations(torch.Generator().manual_seed(2), x, p=0.9)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all() and a.shape == x.shape
    d = taug.draw_augmentations(torch.Generator().manual_seed(3), (512, 1, 8, 8), p=0.333)
    assert abs(float(d["take_clahe"].float().mean()) - 0.333) < 0.07
    assert 1.0 <= float(d["clip"].min()) and float(d["clip"].max()) < 10.0
    assert 0 <= int(d["crop"].min()) and int(d["crop"].max()) <= 10


# ---------------------------------------------------------------------------
# dice and the loss
# ---------------------------------------------------------------------------


def test_dice_matches_jax():
    """Coefficients (NaN for empty channels) and losses, with an empty
    channel, an image whose label channels are all empty, and C = 1."""
    rng = np.random.default_rng(4)
    p = (rng.uniform(size=(4, 3, 16, 16)) > 0.6).astype(np.float32)
    t = (rng.uniform(size=(4, 3, 16, 16)) > 0.5).astype(np.float32)
    p[0, 1], t[0, 1] = 0.0, 0.0  # empty channel
    p[1, 1:], t[1, 1:] = 0.0, 0.0  # no valid channel -> loss 0
    np.testing.assert_allclose(dice_coefficient(_t(p), _t(t)).numpy(),
                               np.asarray(jdice.dice_coefficient(jnp.asarray(p), jnp.asarray(t))),
                               rtol=1e-6, equal_nan=True)
    got = dice_loss(_t(p), _t(t)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdice.dice_loss(jnp.asarray(p), jnp.asarray(t))),
                               rtol=1e-6)
    assert got[1] == 0.0 and np.isnan(dice_coefficient(_t(p), _t(t)).numpy()[0, 0])
    np.testing.assert_array_equal(dice_loss(_t(p[:, :1]), _t(t[:, :1])).numpy(), np.zeros(4))


def _loss_inputs(seed, B=5, C=3, H=24):
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(B, 1, H, H)).astype(np.float32)
    pimg = (img + 0.3 * rng.normal(size=img.shape)).astype(np.float32)
    fg = (rng.uniform(size=(B, C, H, H)) > 0.5).astype(np.float32)
    pfg = (rng.uniform(size=(B, C, H, H)) > 0.4).astype(np.float32)
    rot = rng.normal(0.0, 0.3, (B, 3)).astype(np.float32)
    xyz = rng.normal(0.0, 30.0, (B, 3)).astype(np.float32)
    prot = (rot + rng.normal(0.0, 0.05, rot.shape)).astype(np.float32)
    pxyz = (xyz + rng.normal(0.0, 5.0, xyz.shape)).astype(np.float32)
    keep = np.array([1, 0, 1, 1, 0], np.float32)[:B]
    return img, pimg, fg, pfg, (rot, xyz), (prot, pxyz), keep


@pytest.mark.parametrize("weight_mvc", [0.0, 0.5])
@pytest.mark.parametrize("masked", [False, True])
def test_pose_regression_loss_matches_jax(weight_mvc, masked):
    img, pimg, fg, pfg, (rot, xyz), (prot, pxyz), keep = _loss_inputs(6)
    kw = dict(sdd=1020.0, weight_ncc=1.0, weight_geo=1e-2, weight_dice=1.0, weight_mvc=weight_mvc)
    jl, jm = j_loss(jnp.asarray(img), jnp.asarray(fg) if masked else None,
                    jconvert(jnp.asarray(rot), jnp.asarray(xyz), "euler_angles", "ZXY"),
                    jnp.asarray(pimg), jnp.asarray(pfg) if masked else None,
                    jconvert(jnp.asarray(prot), jnp.asarray(pxyz), "euler_angles", "ZXY"),
                    jnp.asarray(keep), **kw)
    tl, tm = pose_regression_loss(_t(img), _t(fg) if masked else None,
                                  convert(_t(rot), _t(xyz), "euler_angles", "ZXY"),
                                  _t(pimg), _t(pfg) if masked else None,
                                  convert(_t(prot), _t(pxyz), "euler_angles", "ZXY"),
                                  _t(keep), **kw)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    assert (float(tm["mvc"]) > 0) == (weight_mvc > 0)
    assert (float(tm["dice"]) > 0) == masked


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lr,warmup,total", [
    (1e-3, 10, 100), (2e-4, 1000 / 4, 1_000_000 / 4), (1e-3, 10, 12), (1e-3, 1, 4), (3e-4, 7, 1000),
])
def test_schedules_match_optax(lr, warmup, total):
    """Every integer step of a run (and beyond its end) equals optax's
    float32 value; the constant schedule too."""
    ours, theirs = warmup_cosine_schedule(lr, warmup, total), j_warmup_cosine(lr, warmup, total)
    steps = list(range(0, min(int(total), 1000) + 3)) + [int(total) // 2, int(total)]
    got = np.array([ours(s) for s in steps])
    ref = np.array([float(theirs(jnp.int32(s))) for s in steps])
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert ours(0) == 0.0
    assert identity_schedule(lr)(0) == identity_schedule(lr)(12345) == float(j_identity(lr)(0))


# ---------------------------------------------------------------------------
# the optimizer against optax
# ---------------------------------------------------------------------------


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def test_agc_units_follow_the_flax_layout():
    """One AGC unit per output column of a dense kernel and per output
    filter of a convolution kernel, in torch's layout; whole vectors."""
    assert agc_axes((64, 1, 7, 7)) == (1, 2, 3)  # OIHW: flax HWIO axes (0, 1, 2)
    assert agc_axes((10, 512)) == (1,)  # (out, in): flax (in, out) axis 0
    assert agc_axes((64,)) is None and agc_axes((1, 512)) is None


@pytest.mark.parametrize("every_k", [1, 3])
def test_optimizer_matches_optax(every_k):
    """8 gradients through the port's AGC-Adam-MultiSteps and optax's
    ``MultiSteps(chain(adaptive_grad_clip(0.01, eps=1e-3), adam(schedule)),
    every_k)`` on a ResNet-18 tree with seeded gradients (some large enough
    to clip): equal parameters and state leaves after each gradient, and
    the state tree equal to optax's ``to_state_dict`` key for key."""
    model = PoseRegressor("resnet18")
    params_j = to_flax_params(model)
    schedule_j = j_warmup_cosine(1e-2, 2, 8)
    tx = optax.MultiSteps(optax.chain(optax.adaptive_grad_clip(0.01, eps=1e-3),
                                      optax.adam(schedule_j)), every_k_schedule=every_k)
    state_j = tx.init(params_j)
    update_j = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(*tx.update(g, s, p)))

    params_t = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt = AGCAdamMultiSteps(warmup_cosine_schedule(1e-2, 2, 8), every_k=every_k)
    state_t = opt.init(params_t)
    rng = np.random.default_rng(8)
    to_tree = lambda d: to_flax_params(model, d)  # noqa: E731
    for i in range(8):
        scale = 10.0 ** rng.uniform(-4, 0)
        g_tree = jax.tree.map(lambda p: (scale * rng.normal(size=p.shape)).astype(np.float32), params_j)
        params_j, state_j = update_j(g_tree, state_j, params_j)
        g_t = {k: v.to(torch.float32) for k, v in from_flax_params(g_tree).items()}
        moved = opt.step(params_t, g_t, state_t)
        assert moved == ((i + 1) % every_k == 0)
        mine = _flat(to_tree(params_t))
        for key, ref in _flat(jax.device_get(params_j)).items():
            ref = np.asarray(ref)
            np.testing.assert_allclose(mine[key], ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max(),
                                       err_msg=f"step {i} param {key}")
        sd_j = _flat(flax.serialization.to_state_dict(jax.device_get(state_j)))
        sd_t = _flat(opt.state_dict(state_t, to_tree))
        assert sorted(sd_t) == sorted(sd_j)
        for key, ref in sd_j.items():
            ref, got = np.asarray(ref), np.asarray(sd_t[key])
            assert got.dtype == ref.dtype and got.shape == ref.shape, key
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max(),
                                       err_msg=f"step {i} state {key}")
    assert int(np.asarray(sd_t[("inner_opt_state", "1", "0", "count")])) == 8 // every_k


def test_optimizer_state_round_trips():
    """state_dict -> load_state_dict gives back the state, on the
    parameters' dtype and device."""
    model = PoseRegressor("resnet18")
    params = dict(model.named_parameters())
    opt = AGCAdamMultiSteps(identity_schedule(1e-3), every_k=2)
    state = opt.init(params)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        opt.step(params, {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}, state)
    sd = opt.state_dict(state, lambda d: to_flax_params(model, d))
    back = opt.load_state_dict(sd, from_flax_params, params)
    for k in ("mini_step", "gradient_step", "adam_count", "schedule_count"):
        assert back[k] == state[k]
    for tree in ("mu", "nu", "acc_grads"):
        for k, v in state[tree].items():
            assert torch.equal(back[tree][k], v), (tree, k)


def test_first_update_of_a_run_does_not_move():
    """schedule(0) = 0: the first inner update of a warmup run changes no
    weight, as in optax."""
    model = PoseRegressor("resnet18")
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    before = {k: v.clone() for k, v in params.items()}
    opt = AGCAdamMultiSteps(warmup_cosine_schedule(1e-3, 10, 100), every_k=1)
    state = opt.init(params)
    opt.step(params, {k: torch.ones_like(v) for k, v in params.items()}, state)
    assert all(torch.equal(params[k], before[k]) for k in params)
    opt.step(params, {k: torch.ones_like(v) for k, v in params.items()}, state)
    assert not all(torch.equal(params[k], before[k]) for k in params)
