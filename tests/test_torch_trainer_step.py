"""One training step of the port against the JAX package's (CPU,
``XVR_FORCE_SHEARWARP=1``), on tests/test_train.py's tiny dataset (see
tests/test_torch_trainer.py, whose fixtures and helpers this file shares):

* step parity at p_augmentation 0: with the JAX draws (poses, bone
  contrast, augmentation draws) handed to the port and the JAX weights
  carried across (``state.from_flax_params``), the JAX step built from its
  public pieces and the port's ``loss_and_grads`` agree in the loss and
  every metric (rtol 1e-3; mncc, a correlation near 0 at this untrained
  point, also to 1e-3 absolute) and in every parameter gradient's
  direction (cosine >= 0.999 per leaf), masked (with Dice) and unmasked;
* one update: with a constant learning rate the parameters after one step
  agree to 0.15 lr as the root-mean-square over the tree. Adam's first step
  is lr * sign(g) where |g| >> eps, so the ~0.2% of elements whose
  gradients sit at the level of the packages' differences flip sign; no
  single leaf is held.

The CNN's heads are set so that its predictions lie near the middle of the
ranges; the re-render at the predicted poses then sees the volume and its
gradient flows through the shear-warp backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from xvr_tpu.geometry import RigidTransform as JRigidTransform, convert as jconvert
from xvr_tpu.geometry import make_translation as j_make_translation
from xvr_tpu.render.volume import transform_hu_to_density as j_hu_to_density
from xvr_tpu.train import get_random_pose as j_get_random_pose
from xvr_tpu.train import pose_regression_loss as j_loss
from xvr_tpu.train import trainer as jtrainer
from xvr_tpu.train import xray_augmentations as j_aug
from xvr_tpu_torch.state import from_flax_params, to_flax_params

from test_torch_train import jax_aug_draws
from test_torch_trainer import _both, _jax_route, subjects_dataset, tiny_dataset  # noqa: F401
from torch_threads import two_torch_threads  # noqa: F401


def _set_heads(tj, seed=0):
    """Heads of the JAX CNN (then carried to the port) whose predictions sit
    near the middle of the ranges: small random kernels, biases at the
    mean pose."""
    rng = np.random.default_rng(seed)
    mean = jconvert(jnp.asarray([[180.0, 0.0, 0.0]]), jnp.asarray([[0.0, 200.0, 0.0]]),
                    "euler_angles", "ZXY", degrees=True)
    rot, xyz = mean.convert(tj.model.parameterization, tj.model.convention)
    p = jax.tree.map(np.asarray, tj.params)
    for name, bias in (("Dense_0", np.asarray(rot)[0]), ("Dense_1", np.asarray(xyz)[0] / 1000.0)):
        k = p["params"][name]["kernel"]
        p["params"][name]["kernel"] = (rng.normal(size=k.shape) * 2e-3).astype(np.float32)
        p["params"][name]["bias"] = bias.astype(np.float32)
    tj.params = jax.tree.map(jnp.asarray, p)


def _jax_draws(tj, key):
    """The draws of one JAX step for ``key``, as its step makes them."""
    counts = tj.strata_counts
    keys = jax.random.split(key, 2 + len(counts))
    pose = jnp.concatenate([
        j_get_random_pose(keys[2 + k], batch_size=int(counts[k]), **tj.strata_ranges[k]).matrix
        for k in range(len(counts))
    ])
    contrast = jax.random.uniform(keys[0], (), minval=1.0, maxval=10.0)
    return pose, contrast, keys[1]


def _jax_render_fn(tj, subject, density):
    """The JAX step's render of ``subject`` at a pose batch, stratum by
    stratum, from its public pieces."""
    projectors = tj.projectors[subject]
    counts = tj.strata_counts
    offsets = np.concatenate([[0], np.cumsum(counts)])
    packed = [p.pack_for_pallas(density) if p.renderer == "trilinear_pallas" else None
              for p in projectors]
    prepared = [p.prepare_for_shearwarp(density) if p.renderer.endswith(("_fast", "_shearwarp"))
                else None for p in projectors]

    def render(pose):
        imgs = []
        for k, proj in enumerate(projectors):
            pk = JRigidTransform(pose.matrix[int(offsets[k]):int(offsets[k + 1])])
            src, tgt = proj.rays(pk)
            raw = proj.render_rays(src, tgt, density=density, packed=packed[k], prepared=prepared[k])
            imgs.append(proj.reshape_transform(raw, int(counts[k])))
        return jnp.concatenate(imgs) if len(imgs) > 1 else imgs[0]

    return render


def _jax_loss_and_grads(tj, pose_m, contrast, k_aug):
    """The JAX step of Trainer._build_step, from its public pieces, without
    the optimizer."""
    pose = JRigidTransform(pose_m).compose(j_make_translation(tj.centers[0]))
    render = _jax_render_fn(tj, 0, j_hu_to_density(tj.projectors[0][0].volume.data, contrast))
    raw = jax.lax.stop_gradient(render(pose))
    fg = (raw > 0).astype(raw.dtype)
    img = jnp.sum(raw, axis=1, keepdims=True)
    if raw.shape[1] > 1:
        keep = jnp.mean((jnp.sum(raw[:, 1:], axis=1, keepdims=True) > 0).astype(raw.dtype),
                        axis=(1, 2, 3)) > jtrainer.MASK_THRESHOLD
    else:
        keep = jnp.mean(fg, axis=(1, 2, 3)) > jtrainer.IMG_THRESHOLD
    keep = keep.astype(img.dtype)
    x = tj.transforms(j_aug(k_aug, img, p=tj.p_augmentation))

    def loss_fn(params):
        rot, xyz = tj.model.apply(params, x)
        pred = tj.model.decode(rot, xyz)
        praw = render(pred)
        pfg = (praw > 0).astype(praw.dtype)
        pimg = jnp.sum(praw, axis=1, keepdims=True)
        return j_loss(tj.transforms(img), fg, pose, tj.transforms(pimg), pfg, pred, keep, tj.sdd,
                      **tj.loss_weights)

    (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(tj.params)
    return loss, metrics, grads


def _port_draws(tt, pose_m, contrast, k_aug):
    return dict(pose=torch.as_tensor(np.array(pose_m)), contrast=torch.as_tensor(np.array(contrast)),
                aug=jax_aug_draws(k_aug, (tt.batch_size, 1, tt.height, tt.height), tt.p_augmentation))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("masked", [False, True])
def test_step_matches_jax(tiny_dataset, tmp_path, monkeypatch, masked):
    # delx 2: the detector sees the inside of the sphere only. Flat
    # background patches make the local NCC a ratio of rounding residues
    # (variance ~ the 1e-6 floor) in either package
    kw = dict(p_augmentation=0.0, disable_scheduler=True, delx=2.0)
    if masked:
        kw["maskpath"] = tiny_dataset / "mask.nii.gz"
    tj, tt = _both(tiny_dataset, tmp_path, monkeypatch, **kw)
    assert tt.route() == _jax_route(tj)
    _set_heads(tj)
    tt.model.load_state_dict(from_flax_params(tj.params))
    pose_m, contrast, k_aug = _jax_draws(tj, jax.random.PRNGKey(3))
    jl, jm, jg = _jax_loss_and_grads(tj, pose_m, contrast, k_aug)
    draws = _port_draws(tt, pose_m, contrast, k_aug)
    tl, tm, tg = tt.loss_and_grads(tt.projectors[0], tt.centers[0], draws)

    assert float(jm["kept"]) == float(tm["kept"]) > 0
    assert abs(float(jm["mncc"])) > 1e-2, "the re-render must see the volume"
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
    for k in jm:
        # mncc, a correlation near 0 here, also to 1e-3 absolute
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3,
                                   atol=1e-3 if k == "mncc" else 1e-6, err_msg=k)
    if masked:
        assert float(tm["dice"]) > 0
    mine = _flat(to_flax_params(tt.model, tg))
    for key, ref in _flat(jax.device_get(jg)).items():
        got = mine[key]
        cos = float((got * ref).sum() / (np.linalg.norm(got) * np.linalg.norm(ref) + 1e-30))
        assert cos >= 0.999, (key, cos)

    # one update at a constant learning rate. Adam's first step is
    # lr * g / (|g| + eps), lr * sign(g) wherever |g| >> eps, so an element
    # whose gradient sits at the level of the two packages' differences
    # flips sign (a 2 lr step): here ~0.2% of the 11.2M elements, an RMS
    # of ~0.08 lr over the tree. Held: the tree's RMS to 0.15 lr
    tx = optax.MultiSteps(optax.chain(optax.adaptive_grad_clip(0.01, eps=1e-3),
                                      optax.adam(optax.constant_schedule(1e-3))), every_k_schedule=1)
    upd, _ = tx.update(jg, tx.init(tj.params), tj.params)
    jp = _flat(jax.device_get(optax.apply_updates(tj.params, upd)))
    tt.tx.step(tt.params, tg, tt.opt_state)
    mine = _flat(to_flax_params(tt.model))
    sq = sum(float(((mine[k].astype(np.float64) - ref) ** 2).sum()) for k, ref in jp.items())
    n = sum(ref.size for ref in jp.values())
    assert np.sqrt(sq / n) <= 1e-3 * 0.15, np.sqrt(sq / n)


def test_target_renders_of_each_subject_match_jax(subjects_dataset, tmp_path, monkeypatch):
    """A directory of three CTs of different depths with their labelmaps
    (tests/test_torch_trainer.py): at one step's JAX draws, the port's step
    on each subject renders the same targets (the background and both label
    channels) as the JAX step's render of that subject, padded alike. Held
    to tests/test_torch_channels.py's tolerances: rtol 2e-2 and 2e-3 of
    the largest value (the JAX package's bf16 accumulate)."""
    tj, tt = _both(subjects_dataset, tmp_path, monkeypatch, volpath=subjects_dataset / "volumes",
                   maskpath=subjects_dataset / "masks", p_augmentation=0.0)
    pose_m, contrast, k_aug = _jax_draws(tj, jax.random.PRNGKey(5))
    draws = _port_draws(tt, pose_m, contrast, k_aug)
    render_batch = tt.render_batch

    class Target(Exception):
        """The step's first render, its target, ending the step there."""

    def target(*a, **kw):
        raise Target(render_batch(*a, **kw))

    tt.render_batch = target
    for s in range(len(tt.projectors)):
        with pytest.raises(Target) as got:
            tt.loss_and_grads(tt.projectors[s], tt.centers[s], draws)
        got = got.value.args[0].numpy()
        pose = JRigidTransform(pose_m).compose(j_make_translation(tj.centers[s]))
        render = _jax_render_fn(tj, s, j_hu_to_density(tj.projectors[s][0].volume.data, contrast))
        ref = np.asarray(render(pose))
        assert got.shape == ref.shape and got.shape[1] == 3
        assert (ref[:, 2].max() > 0) == (s > 0), s  # the first subject lacks label 2
        np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-3 * np.abs(ref).max(),
                                   err_msg=f"subject {s}")
