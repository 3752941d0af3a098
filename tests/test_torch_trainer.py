"""The port's Trainer against the JAX package's (CPU, ``XVR_FORCE_SHEARWARP=1``).

On tests/test_train.py's tiny dataset (a 24^3 two-tissue sphere with a
one-label core, 32^2 DRRs, ResNet-18, batch 3):

* route parity: for the ranges of tests/test_train.py's strata, masked and
  slab-fallback cases both packages pick the same renderer, alpha strata,
  batch shares, permutations and label slab bounds;
* the train loop: logs, checkpoints with the optimizer state, the figure
  of target and predicted DRRs at step 0;
* ``pad_volumes``.

One step against the JAX package's: tests/test_torch_trainer_step.py.
"""

import numpy as np
import pytest
import torch

from xvr_tpu.io import save_nifti
from xvr_tpu.train import trainer as jtrainer
from xvr_tpu_torch.render import Volume
from xvr_tpu_torch.train import Trainer, pad_volumes


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
WIDE = dict(alphamin=75.0, alphamax=270.0, betamin=-5.0, betamax=5.0, gammamin=-5.0, gammamax=5.0,
            txmin=-5.0, txmax=5.0, tymin=150.0, tymax=250.0, tzmin=-5.0, tzmax=5.0)


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    """tests/test_train.py's dataset: a 24^3 sphere with a bone core, and
    the core as label 1."""
    d = tmp_path_factory.mktemp("data")
    n = 24
    c = (n - 1) / 2
    idx = np.arange(n)
    X, Y, Z = np.meshgrid(idx, idx, idx, indexing="ij")
    r2 = (X - c) ** 2 + (Y - c) ** 2 + (Z - c) ** 2
    hu = np.where(r2 <= (n / 3) ** 2, 200.0, -1000.0).astype(np.float32)
    hu += np.where(r2 <= (n / 6) ** 2, 800.0, 0.0)
    affine = np.eye(4) * 4.0
    affine[3, 3] = 1.0
    affine[:3, 3] = -c * 4.0
    save_nifti(d / "volume.nii.gz", hu, affine)
    save_nifti(d / "mask.nii.gz", np.where(r2 <= (n / 6) ** 2, 1.0, 0.0).astype(np.float32), affine)
    return d


def _kwargs(tiny_dataset, outdir, **kw):
    out = dict(volpath=tiny_dataset / "volume.nii.gz", maskpath=None, outpath=outdir,
               sdd=400.0, height=32, delx=4.0, model_name="resnet18", batch_size=3,
               n_total_itrs=4, n_warmup_itrs=1, n_grad_accum_itrs=1, n_save_every_itrs=100,
               lr=1e-3, **RANGES)
    out.update(kw)
    return out


def _both(tiny_dataset, tmp_path, monkeypatch, **kw):
    monkeypatch.setenv("XVR_FORCE_SHEARWARP", "1")
    tj = jtrainer.Trainer(**_kwargs(tiny_dataset, tmp_path / "j", **kw))
    tt = Trainer(**_kwargs(tiny_dataset, tmp_path / "t", **kw), device="cpu")
    return tj, tt


def _jax_route(tj):
    projs = tj.projectors[0]
    return dict(
        renderer=projs[0].renderer, labels=tj.labels,
        strata=[dict(alpha=(sr["alphamin"], sr["alphamax"]), count=c, perm=p.pallas_perm,
                     bounds=p.shearwarp_bounds)
                for sr, c, p in zip(tj.strata_ranges, tj.strata_counts, projs)],
    )


@pytest.mark.parametrize("case", ["single", "masked", "wide", "wide_masked", "slab", "slab_masked",
                                  "siddon", "siddon_exact"])
def test_route_matches_jax(tiny_dataset, tmp_path, monkeypatch, case):
    """Renderer, strata edges and shares, permutations and label slab
    bounds. The slab cases: on one subject no ranges make every shear-warp
    candidate decline while the slab gate accepts (the slab gate is the
    stricter on the same probes), so the JAX trainer's strata are declined
    by hand in both packages."""
    kw = {}
    if "wide" in case:
        kw = dict(WIDE, batch_size=8)
    if "masked" in case:
        kw["maskpath"] = tiny_dataset / "mask.nii.gz"
    if case.startswith("slab"):
        monkeypatch.setattr(jtrainer.Trainer, "_try_shearwarp_strata", lambda self, edges: False)
        monkeypatch.setattr(Trainer, "_try_shearwarp_strata", lambda self, edges: False)
    if case.startswith("siddon"):
        kw["renderer"] = case
    tj, tt = _both(tiny_dataset, tmp_path, monkeypatch, **kw)
    ours, theirs = tt.route(), _jax_route(tj)
    assert ours == theirs
    assert tt._stratum_candidates() == tj._stratum_candidates()
    expect = {"single": "trilinear_fast", "masked": "trilinear_fast", "wide": "trilinear_fast",
              "wide_masked": "trilinear_fast", "slab": "trilinear_pallas",
              "slab_masked": "trilinear_pallas", "siddon": "siddon_fast",
              "siddon_exact": "siddon"}[case]
    assert ours["renderer"] == expect
    assert {k: v for k, v in tt.config.items() if k != "outpath"} == \
        {k: v for k, v in tj.config.items() if k != "outpath"}
    if "wide" in case:
        assert [s["alpha"] for s in ours["strata"]] == [(75.0, 135.0), (135.0, 225.0), (225.0, 270.0)]
        assert len({s["perm"] for s in ours["strata"]}) >= 2
    if case == "masked":
        assert ours["strata"][0]["bounds"][1][1] - ours["strata"][0]["bounds"][1][0] < 24


def test_pad_volumes_and_train_loop(tiny_dataset, tmp_path, monkeypatch):
    """pad_volumes pads with air and label 0 (tests/test_train.py's case);
    the train loop logs every step, writes checkpoints with the optimizer
    state, and logs the 2 x 4 grid of target and predicted DRRs at step 0
    (tests/test_torch_visualization.py holds its images against JAX's)."""
    a = Volume(data=torch.zeros((4, 6, 8)), affine=torch.eye(4), mask=None)
    b = Volume(data=torch.zeros((6, 4, 8)), affine=torch.eye(4), mask=torch.zeros((6, 4, 8), dtype=torch.int32))
    out = pad_volumes([a, b])
    assert out[0].shape == out[1].shape == (6, 6, 8) and tuple(out[1].mask.shape) == (6, 6, 8)
    assert float(out[0].data[5].max()) == -1000.0

    monkeypatch.setenv("XVR_FORCE_SHEARWARP", "1")
    tt = Trainer(**_kwargs(tiny_dataset, tmp_path / "loop", n_total_itrs=3, n_save_every_itrs=2,
                           n_grad_accum_itrs=2), device="cpu")

    class Run:
        logged = []

        def log(self, m):
            self.logged.append(m)

    run = Run()
    last = tt.train(run=run, progress=False)
    assert last["itr"] == 2 and np.isfinite(last["loss"])
    assert [m["itr"] for m in run.logged if "imgs" not in m] == [0, 1, 2]
    figs = [m for m in run.logged if "imgs" in m]
    assert [m["itr"] for m in figs] == [0] and len(figs[0]["imgs"].axes) == 8
    assert sorted(p.name for p in (tmp_path / "loop").glob("*.ckpt")) == ["0000.ckpt", "0001.ckpt", "0002.ckpt"]
    assert tt.opt_state["gradient_step"] == 1 and tt.opt_state["mini_step"] == 1


def test_multi_subject_patches_and_reframe(tiny_dataset, tmp_path, monkeypatch):
    """A directory of CTs (padded to one shape) with subject weights and
    random patch crops trains finitely (tests/test_train.py's slow case, at
    the port's speed); an identity ITK warp gives the loss of no warp."""
    import shutil

    monkeypatch.setenv("XVR_FORCE_SHEARWARP", "1")
    vols = tmp_path / "vols"
    vols.mkdir()
    shutil.copy(tiny_dataset / "volume.nii.gz", vols / "a.nii.gz")
    shutil.copy(tiny_dataset / "volume.nii.gz", vols / "b.nii.gz")
    tt = Trainer(**_kwargs(tiny_dataset, tmp_path / "multi", volpath=vols, weights=[0.7, 0.3],
                           patch_size=(16, 16, 16)), device="cpu")
    assert len(tt.projectors) == 2 and not tt.single_subject
    for itr in range(2):
        assert np.isfinite(float(tt.step(itr)["loss"]))

    itk = tmp_path / "warp.txt"
    itk.write_text("#Insight Transform File V1.0\n#Transform 0\n"
                   "Transform: AffineTransform_double_3_3\n"
                   "Parameters: 1 0 0 0 1 0 0 0 1 0 0 0\nFixedParameters: 0 0 0\n")
    plain = Trainer(**_kwargs(tiny_dataset, tmp_path / "o1", seed=9), device="cpu")
    warped = Trainer(**_kwargs(tiny_dataset, tmp_path / "o2", seed=9, warp=itk), device="cpu")
    np.testing.assert_allclose(warped.reframe.matrix.reshape(4, 4).numpy(), np.eye(4), atol=1e-5)
    np.testing.assert_allclose(float(warped.step(0)["loss"]), float(plain.step(0)["loss"]), rtol=1e-4)
