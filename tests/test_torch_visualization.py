"""The port's visualization against the JAX package's (CPU, matplotlib Agg).

* ``viz2d``: ``plot_drr``, ``plot_mask`` and ``plot_registration`` draw what
  they are given (the registration's mTRE in its title);
* ``animate``: the port's ``render_trajectory`` re-renders a registration
  bundle's frames as the JAX package's ``animate`` does (its images caught at
  ``imshow``), both with the golden trilinear renderer in float32: to rtol
  1e-4 / atol 1e-4 of the image maximum (tests/test_torch_render.py); the
  port's ``animate`` writes one GIF frame per re-rendered pose;
* the trainer's figures: at the same poses and weights, the port's
  ``figure_images`` grid against the one the JAX trainer's ``_log_figures``
  logs, to the same tolerance.
"""

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from xvr_tpu.train import get_random_pose as j_get_random_pose  # noqa: E402
from xvr_tpu.visualization import animate as j_animate  # noqa: E402
from xvr_tpu_torch.geometry import RigidTransform, convert  # noqa: E402
from xvr_tpu_torch.io import dcmwrite, read, save_nifti  # noqa: E402
from xvr_tpu_torch.render import Projector  # noqa: E402
from xvr_tpu_torch.state import from_flax_params  # noqa: E402
from xvr_tpu_torch.visualization import (  # noqa: E402
    animate,
    load_bundle,
    plot_drr,
    plot_mask,
    plot_registration,
    render_trajectory,
)

from xvr_tpu.train import trainer as jtrainer  # noqa: E402
from test_torch_trainer import RANGES, _kwargs, tiny_dataset  # noqa: E402,F401
from test_torch_trainer_step import _set_heads  # noqa: E402


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, ref):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A two-stage registration's result bundle, written by the port's
    registrar on the CPU: a 24^3 two-tissue sphere, its 32^2 X-ray."""
    from xvr_tpu_torch.registrar import RegistrarFixed

    d = tmp_path_factory.mktemp("bundle")
    n, c = 24, 11.5
    X, Y, Z = np.meshgrid(*([np.arange(n)] * 3), indexing="ij")
    r2 = (X - c) ** 2 + (Y - c) ** 2 + (Z - c) ** 2
    hu = np.where(r2 <= 8**2, 200.0, -1000.0).astype(np.float32) + np.where(r2 <= 4**2, 800.0, 0.0)
    aff = np.eye(4) * 4.0
    aff[3, 3] = 1.0
    aff[:3, 3] = -c * 4.0
    save_nifti(d / "ct.nii.gz", hu, aff)
    proj = Projector.from_volume(read(d / "ct.nii.gz", device="cpu"), sdd=400.0, height=32, delx=6.0)
    gt = convert(torch.tensor([[183.0, -2.0, 4.0]]), torch.tensor([[2.0, 200.0, -3.0]]),
                 "euler_angles", "ZXY", degrees=True)
    with torch.no_grad():
        img = proj(gt)[0, 0].numpy()
    dcmwrite(d / "xray.dcm", (img / img.max() * 60000).astype(np.uint16), sdd=400.0,
             row_spacing=6.0, col_spacing=6.0)
    reg = RegistrarFixed(volume=d / "ct.nii.gz", mask=None, orientation="AP",
                         rot=[np.pi, 0.0, 0.0], xyz=[0.0, 200.0, 0.0], linearize=False,
                         scales="2,1", n_itrs="4,4", reverse_x_axis=False, lr_rot=5e-3, lr_xyz=1.0,
                         verbose=0, restart_seeds=1, max_restarts=0, device="cpu")
    return reg(d / "xray.dcm", d / "out", beta=1.0)


def test_viz2d_draws_its_inputs():
    rng = np.random.default_rng(0)
    imgs = rng.uniform(size=(3, 1, 8, 10)).astype(np.float32)
    axs = plot_drr(torch.as_tensor(imgs), title="DRR", ticks=False)
    assert len(axs) == 3
    for ax, img in zip(axs, imgs):
        np.testing.assert_array_equal(ax.images[0].get_array(), img[0])
        assert ax.get_title() == "DRR" and not len(ax.get_xticks())
    masks = (rng.uniform(size=(3, 2, 8, 10)) > 0.5).astype(np.float32)
    plot_mask(masks, axs, alpha=0.5)
    for ax, m in zip(axs, masks):
        assert len(ax.images) == 3  # the DRR and one overlay per channel
        np.testing.assert_array_equal(ax.images[2].get_array()[..., 3], 0.5 * (m[1] > 0))
    plt.close("all")


def test_plot_registration_titles_the_mtre(bundle, tmp_path):
    from xvr_tpu_torch.metrics import Evaluator
    from xvr_tpu_torch.visualization import rebuild_projector

    arrays, meta = load_bundle(bundle)
    proj = rebuild_projector(meta, device="cpu").rescale_detector(2.0)
    true, pred = (RigidTransform(torch.as_tensor(arrays[k])) for k in ("init_pose", "final_pose"))
    fids = torch.tensor([[[0.0, 0.0, 0.0], [10.0, -5.0, 3.0], [-8.0, 6.0, -4.0]]])
    fig = plot_registration(proj, fids, true, pred, save_path=tmp_path / "reg.png")
    mtre = float(Evaluator(proj, fids)(true, pred)[..., 2])
    assert fig._suptitle.get_text() == f"mTRE = {mtre:.2f} mm" and mtre > 0
    assert (tmp_path / "reg.png").stat().st_size > 0
    with torch.no_grad():
        np.testing.assert_array_equal(fig.axes[1].images[0].get_array(), proj(true).numpy().squeeze())


def _jax_frames(bundle, tmp_path, monkeypatch, skip):
    """The JAX package's animate on the bundle, its panels caught at imshow."""
    shown = []
    orig = matplotlib.axes.Axes.imshow

    def spy(ax, im, *a, **k):
        shown.append(np.asarray(im))
        return orig(ax, im, *a, **k)

    monkeypatch.setattr(matplotlib.axes.Axes, "imshow", spy)
    j_animate(bundle, tmp_path / "jax.gif", skip=skip, dpi=24)
    monkeypatch.undo()
    return list(zip(shown[0::2], shown[1::2]))


def test_render_trajectory_matches_jax_animate(bundle, tmp_path, monkeypatch):
    skip = 2
    frames = render_trajectory(bundle, skip=skip, device="cpu")
    params = load_bundle(bundle)[0]["trajectory_params"]
    assert [t for t, _, _ in frames] == list(range(0, len(params), skip))
    ref = _jax_frames(bundle, tmp_path, monkeypatch, skip)
    assert len(ref) == len(frames)
    assert len({img.shape for _, img, _ in frames}) > 1  # the pyramid advances
    for (_, img, xray), (jimg, jxray) in zip(frames, ref):
        assert img.shape == jimg.shape == xray.shape
        _close(img, jimg)
        _close(xray, jxray)


def test_animate_writes_a_gif_frame_per_pose(bundle, tmp_path, capsys):
    import imageio.v3 as iio

    n = len(load_bundle(bundle)[0]["trajectory_params"])
    out = animate(bundle, tmp_path / "run.gif", skip=3, dpi=24, fps=5, device="cpu")
    assert out == tmp_path / "run.gif"
    assert iio.imread(out, index=None).shape[0] == len(range(0, n, 3))
    # no video backend here: an .mp4 request falls back to a GIF beside it
    try:
        import imageio_ffmpeg  # noqa: F401
    except ImportError:
        out = animate(bundle, tmp_path / "run.mp4", skip=3, dpi=24, device="cpu")
        assert out == tmp_path / "run.gif" and "No video backend" in capsys.readouterr().out


def _jax_figure_trainer(tiny_dataset, seed=0):
    """What the JAX trainer's _log_figures reads, without the rest of its
    Trainer: the ResNet-18 regressor (its apply jitted) with heads near the
    mean pose, the subject's golden projector, the first stratum's ranges
    and a PRNG key."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    from xvr_tpu.io.volumes import read as jread
    from xvr_tpu.models import PoseRegressor as JPoseRegressor
    from xvr_tpu.render import Projector as JProjector
    from xvr_tpu.utils.transforms import make_xray_transforms as j_transforms

    model = JPoseRegressor(model_name="resnet18", parameterization="quaternion_adjugate",
                           convention="ZXY", norm_layer="groupnorm", unit_conversion_factor=1000.0)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 1, 32, 32)))
    vol = jread(tiny_dataset / "volume.nii.gz")
    proj = JProjector.from_volume(vol, sdd=400.0, height=32, delx=4.0)
    tj = SimpleNamespace(model=model, params=params, projectors=[(proj,)], centers=[vol.center],
                         strata_ranges=[RANGES], transforms=j_transforms(32), reframe=None,
                         key=jax.random.PRNGKey(seed + 1))
    _set_heads(tj)
    # kernels 100x smaller than the step test's: on these 32^2 renders its
    # predictions stray 100 mm off the volume
    p = jax.tree.map(np.asarray, tj.params)
    for name in ("Dense_0", "Dense_1"):
        p["params"][name]["kernel"] = p["params"][name]["kernel"] * 1e-2
    tj.params = jax.tree.map(jnp.asarray, p)
    tj.model = SimpleNamespace(apply=jax.jit(model.apply), decode=model.decode,
                               parameterization=model.parameterization,
                               convention=model.convention)
    return tj


def test_log_figures_grid_matches_jax(tiny_dataset, tmp_path, monkeypatch):
    """With the JAX weights carried to the port and the JAX trainer's figure
    poses, the port's target and predicted DRRs are the grid the JAX
    trainer's _log_figures logs; the port's own _log_figures logs a 2 x 4
    grid of its figure_images at poses from its generator."""
    from xvr_tpu_torch.train import Trainer, get_random_pose

    tj = _jax_figure_trainer(tiny_dataset)
    tt = Trainer(**_kwargs(tiny_dataset, tmp_path / "t"), device="cpu")
    assert tt.strata_ranges[0] == RANGES and tt.projectors[0][0].renderer == "trilinear"
    tt.model.load_state_dict(from_flax_params(jax.device_get(tj.params)))

    class Run:
        def __init__(self):
            self.logged = []

        def log(self, m):
            self.logged.append(m)

    _, k_pose = jax.random.split(tj.key)
    jpose = np.array(j_get_random_pose(k_pose, batch_size=4, **RANGES).matrix)
    jrun = Run()
    jtrainer.Trainer._log_figures(tj, 7, jrun)
    jfig = jrun.logged[0]["imgs"]
    jimgs = np.stack([ax.images[0].get_array() for ax in jfig.axes])
    got = tt.figure_images(RigidTransform(torch.as_tensor(jpose)))
    assert tuple(got.shape) == (8, 1, 32, 32) and jimgs.shape == (8, 32, 32)
    assert got[4:].abs().max() > 0  # the predictions view the volume
    _close(got[:, 0].numpy(), jimgs)

    gen = torch.Generator().set_state(tt.generator.get_state())
    run = Run()
    tt._log_figures(7, run)
    assert run.logged[0]["itr"] == 7
    fig = run.logged[0]["imgs"]
    want = tt.figure_images(get_random_pose(gen, batch_size=4, device="cpu", **RANGES))
    np.testing.assert_array_equal(np.stack([ax.images[0].get_array() for ax in fig.axes]),
                                  want[:, 0].numpy())
    plt.close("all")
