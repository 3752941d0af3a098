"""The port's device mesh against the JAX package's (CPU).

Mirrors tests/test_parallel.py. The port's mesh is driven by one process, as
the JAX package's is; here its slots all name the CPU (``make_mesh(devices=
["cpu"] * 8)``), as the JAX tests' mesh spans 8 virtual host devices
(tests/conftest.py). A sharded render must equal the unsharded one, and the
ray-sharded shear-warp render (slope grid fitted to the full detector) the
unsharded fast render and the JAX package's ``ray_sharded_fast_render``:
forward to rtol/atol 5e-5, pose gradient to JAX's norm-aware tolerance
(rtol 2e-2, atol 1e-4 * max, cosine > 1 - 1e-8). A sharded registration and
a sharded training step must reproduce the mesh-free runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvr_tpu.geometry import RigidTransform as JRigidTransform, convert as jconvert
from xvr_tpu.geometry import make_translation as j_make_translation
from xvr_tpu.parallel import make_mesh as j_make_mesh, ray_sharded_fast_render as j_rs_fast
from xvr_tpu.render import Projector as JProjector
from xvr_tpu.render.volume import make_test_volume as j_make_test_volume
from xvr_tpu_torch.geometry import RigidTransform, convert, make_translation
from xvr_tpu_torch.io import dcmwrite, save_nifti
from xvr_tpu_torch.parallel import (
    gather,
    make_mesh,
    ray_sharded_render,
    replicated,
    shard_batch,
    shard_batch_flat,
    shard_rays,
)
from xvr_tpu_torch.parallel import mesh as pmesh
from xvr_tpu_torch.render import Projector, Volume
from xvr_tpu_torch.train import Trainer

CPU8 = ["cpu"] * 8
RANGES = dict(
    alphamin=165.0, alphamax=195.0, betamin=-15.0, betamax=15.0,
    gammamin=-15.0, gammamax=15.0, txmin=-10.0, txmax=10.0,
    tymin=150.0, tymax=250.0, tzmin=-10.0, tzmax=10.0,
)
ROT = [[180.0, 5.0, -3.0], [170.0, -5.0, 3.0], [185.0, 2.0, 1.0], [175.0, -2.0, -1.0]]
XYZ = [[0.0, 200.0, 0.0], [5.0, 220.0, -5.0], [-3.0, 210.0, 2.0], [2.0, 205.0, -2.0]]


@pytest.fixture
def two_torch_threads():
    """Two torch threads: the suite runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write_phantom(d, mask=False):
    """tests/test_parallel.py's 24^3 two-tissue sphere (and its bone core as
    label 1)."""
    n, spacing = 24, 4.0
    c = (n - 1) / 2
    idx = np.arange(n)
    X, Y, Z = np.meshgrid(idx, idx, idx, indexing="ij")
    r2 = (X - c) ** 2 + (Y - c) ** 2 + (Z - c) ** 2
    hu = np.where(r2 <= (n / 3) ** 2, 200.0, -1000.0).astype(np.float32)
    hu += np.where(r2 <= (n / 6) ** 2, 800.0, 0.0)
    aff = np.eye(4) * spacing
    aff[3, 3] = 1.0
    aff[:3, 3] = -c * spacing
    save_nifti(d / "ct.nii.gz", hu, aff)
    if mask:
        save_nifti(d / "mask.nii.gz", (hu > 300.0).astype(np.float32), aff)
    return d / "ct.nii.gz"


@pytest.fixture(scope="module")
def sphere():
    """tests/test_parallel.py's fast-render scene on both sides: the JAX
    sphere phantom, its 32^2 projector upgraded to shear-warp at four poses
    about the volume centre, and the port's projector on the same arrays."""
    jvol = j_make_test_volume(24, spacing=4.0, kind="sphere")
    jproj = JProjector.from_volume(jvol, sdd=400.0, height=32, delx=4.0)
    jpose = jconvert(jnp.asarray(ROT), jnp.asarray(XYZ), parameterization="euler_angles",
                     convention="ZXY", degrees=True).compose(j_make_translation(jvol.center))
    jfast = jproj.with_shearwarp(jpose)
    assert jfast.renderer == "trilinear_fast"
    vol = Volume(data=torch.tensor(np.asarray(jvol.data)), affine=torch.tensor(np.asarray(jvol.affine)))
    proj = Projector.from_volume(vol, sdd=400.0, height=32, delx=4.0)
    fast = proj.replace(renderer="trilinear_fast", pallas_perm=tuple(jfast.pallas_perm))
    pose = RigidTransform(torch.tensor(np.asarray(jpose.matrix)))
    return dict(jfast=jfast, jprep=jfast.prepare_for_shearwarp(jfast.density), jpose=jpose,
                proj=proj, fast=fast, prep=fast.prepare_for_shearwarp(), pose=pose)


def test_make_mesh_shapes():
    """The (dp, rays) shapes of the JAX package's make_mesh, its refusal of
    an indivisible ray axis, and a request for more slots than devices."""
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual CPU devices"
    for n, rays in [(2, None), (8, None), (8, 1), (4, None), (6, None), (8, 4)]:
        mesh = make_mesh(n, rays=rays, devices=CPU8)
        assert mesh.shape == dict(j_make_mesh(n, rays=rays).shape), (n, rays)
        assert mesh.size == n and mesh.axis_names == ("dp", "rays")
        assert mesh.devices.shape == (n // mesh.shape["rays"], mesh.shape["rays"])
        assert mesh.first == torch.device("cpu") and len(mesh.slots) == n
    with pytest.raises(ValueError):
        make_mesh(6, rays=4, devices=CPU8)
    with pytest.raises(ValueError, match="9 slots asked for, but only 8 devices given"):
        make_mesh(9, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="0 slots asked for \\(0 CUDA devices\\)"):
            make_mesh()


def test_shards_and_gathers():
    """shard_batch splits over dp, shard_batch_flat over every slot,
    shard_rays over (dp, rays), in slot order; gather undoes them."""
    mesh = make_mesh(8, devices=CPU8)  # dp 4, rays 2
    x = torch.arange(16.0).reshape(8, 2)
    assert [tuple(c.shape) for c in shard_batch(mesh, x)] == [(2, 2)] * 4
    assert [tuple(c.shape) for c in shard_batch_flat(mesh, x)] == [(1, 2)] * 8
    torch.testing.assert_close(gather(mesh, shard_batch_flat(mesh, x)), x, rtol=0, atol=0)
    r = torch.arange(4 * 6 * 3.0).reshape(4, 6, 3)
    chunks = shard_rays(mesh, r)
    assert [tuple(c.shape) for c in chunks] == [(1, 3, 3)] * 8
    torch.testing.assert_close(chunks[1], r[:1, 3:], rtol=0, atol=0)
    rows = [gather(mesh, chunks[i : i + 2], dim=1) for i in range(0, 8, 2)]
    torch.testing.assert_close(torch.cat(rows), r, rtol=0, atol=0)
    reps = replicated(mesh, (x, None))
    assert len(reps) == 8 and all(rep[0] is reps[0][0] and rep[1] is None for rep in reps)


@pytest.mark.parametrize("labels", [None, (1,)])
def test_shard_rays_render_matches_unsharded(labels):
    """A golden render with its rays split over (dp, rays) equals the
    unsharded render, channels too, and the JAX package's render."""
    jvol = j_make_test_volume(24, spacing=4.0, kind="sphere")
    mask = (np.asarray(jvol.data) > 500.0).astype(np.int32)
    vol = Volume(data=torch.tensor(np.asarray(jvol.data)), affine=torch.tensor(np.asarray(jvol.affine)),
                 mask=torch.tensor(mask))
    proj = Projector.from_volume(vol, sdd=400.0, height=32, delx=4.0, n_samples=64, labels=labels)
    pose = convert(torch.tensor(ROT[:2]), torch.tensor(XYZ[:2]), "euler_angles", "ZXY",
                   degrees=True).compose(make_translation(vol.center))
    ref = proj.render_rays(*proj.rays(pose))
    out = ray_sharded_render(make_mesh(8, devices=CPU8), proj, pose)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    if labels is None:
        jproj = JProjector.from_volume(jvol, sdd=400.0, height=32, delx=4.0, n_samples=64)
        jref = np.asarray(jproj.render_rays(*jproj.rays(JRigidTransform(jnp.asarray(pose.matrix)))))
        np.testing.assert_allclose(out.numpy(), jref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B", [4, 1])
def test_ray_sharded_fast_render_matches_unsharded_and_jax(sphere, B):
    """B=4 splits the batch over dp and the rows over rays; B=1 replicates the
    batch and splits the rows over all 8 slots. The forward equals the
    unsharded fast render bit for bit (the same bounds, K1 on identical
    inputs, K2 per pixel) and the JAX package's to 5e-5."""
    mesh = make_mesh(8, devices=CPU8)
    fast, pose = sphere["fast"], sphere["pose"][:B]
    ref = fast.render_rays(*fast.rays(pose), prepared=sphere["prep"])
    out = pmesh.ray_sharded_fast_render(mesh, fast, pose, prepared=sphere["prep"])
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    jmesh = j_make_mesh(8)
    with jmesh:
        jout = jax.jit(lambda m: j_rs_fast(jmesh, sphere["jfast"], JRigidTransform(m),
                                           prepared=sphere["jprep"]))(sphere["jpose"].matrix[:B])
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=5e-5, atol=5e-5)


def test_ray_sharded_fast_render_gradient(sphere):
    """Pose gradients through the row blocks (K3, the warp transpose and K4
    under the full detector's bounds, summed by autograd) against the
    unsharded render's and JAX's, with JAX's norm-aware tolerance."""
    mesh = make_mesh(8, devices=CPU8)
    fast, prep = sphere["fast"], sphere["prep"]

    def grad(render):
        m = sphere["pose"].matrix.clone().requires_grad_(True)
        (g,) = torch.autograd.grad((render(RigidTransform(m)) ** 2).sum(), m)
        return g.numpy().ravel().astype(np.float64)

    g_sharded = grad(lambda p: pmesh.ray_sharded_fast_render(mesh, fast, p, prepared=prep))
    g_ref = grad(lambda p: fast.render_rays(*fast.rays(p), prepared=prep))
    jmesh = j_make_mesh(8)
    with jmesh:
        jg = jax.jit(jax.grad(lambda m: jnp.sum(j_rs_fast(
            jmesh, sphere["jfast"], JRigidTransform(m), prepared=sphere["jprep"]) ** 2)))(
                sphere["jpose"].matrix)
    assert np.isfinite(g_sharded).all()
    for b in (g_ref, np.asarray(jg).ravel().astype(np.float64)):
        np.testing.assert_allclose(g_sharded, b, rtol=2e-2, atol=1e-4 * np.abs(b).max())
        cos = float(g_sharded @ b / (np.linalg.norm(g_sharded) * np.linalg.norm(b)))
        assert cos > 1.0 - 1e-8, cos


def test_ray_sharded_fast_render_refusals(sphere):
    mesh = make_mesh(8, devices=CPU8)
    with pytest.raises(ValueError, match="fast renderer required"):
        pmesh.ray_sharded_fast_render(mesh, sphere["proj"], sphere["pose"])
    chans = sphere["prep"][None].expand(2, *sphere["prep"].shape)
    with pytest.raises(ValueError, match="single-channel"):
        pmesh.ray_sharded_fast_render(mesh, sphere["fast"], sphere["pose"], prepared=chans)


def _xray(tmp_path, height, delx):
    from xvr_tpu_torch.io import read

    volpath = _write_phantom(tmp_path)
    proj = Projector.from_volume(read(volpath, device="cpu"), sdd=400.0, height=height, delx=delx)
    gt_pose = convert(torch.tensor([[183.0, -2.0, 4.0]]), torch.tensor([[2.0, 200.0, -3.0]]),
                      "euler_angles", "ZXY", degrees=True)
    with torch.no_grad():
        img = proj(gt_pose)[0, 0].numpy()
    xray = tmp_path / "xray.dcm"
    dcmwrite(xray, (img / img.max() * 60000).astype(np.uint16), sdd=400.0, row_spacing=delx,
             col_spacing=delx)
    return volpath, xray


def test_mesh_batched_registration(tmp_path, two_torch_threads):
    """Batched registration over an 8-slot dp mesh: rows of a duplicated
    X-ray stay identical, K=3 pads to 8 and truncates back, and the run
    starts from the mesh-free run's similarity."""
    from xvr_tpu_torch.registrar import RegistrarFixed

    volpath, xray = _xray(tmp_path, 32, 6.0)

    def make_reg(mesh):
        return RegistrarFixed(
            volume=volpath, mask=None, orientation="AP",
            rot=[np.pi, 0.0, 0.0], xyz=[0.0, 200.0, 0.0],
            linearize=False, scales="1", n_itrs="4",
            reverse_x_axis=False, lr_rot=5e-3, lr_xyz=1.0,
            max_n_plateaus=4, verbose=0, mesh=mesh, device="cpu", max_restarts=0,
        )

    mesh = make_mesh(8, rays=1, devices=CPU8)
    res = make_reg(mesh).run_batch([xray] * 8, beta=1.0)
    assert len(res) == 8
    for r in res[1:]:
        np.testing.assert_array_equal(res[0][4].matrix.numpy(), r[4].matrix.numpy())
        np.testing.assert_array_equal(res[0][5]["trajectory"]["ncc"], r[5]["trajectory"]["ncc"])

    reg3 = make_reg(mesh)
    res3 = reg3.run_batch([xray] * 3, beta=1.0)
    assert len(res3) == 3 and reg3.stage_log[0]["K"] == 8 * reg3.restart_seeds

    ref = make_reg(None).run_batch([xray], beta=1.0)
    np.testing.assert_allclose(res[0][5]["trajectory"]["ncc"][0], ref[0][5]["trajectory"]["ncc"][0],
                               atol=1e-5)


@pytest.mark.parametrize("seeds", [4, 1])
def test_mesh_single_xray_auto_ray_sharded(tmp_path, monkeypatch, seeds, two_torch_threads):
    """A K=1 registration on a mesh is not padded out with duplicates: a
    stage batch (K * seeds) that does not fill the mesh renders through
    ray_sharded_fast_render (the spy), B=4 with the batch over dp and B=1
    with the rows over all 8 slots. Detector height 36 takes the row-pad
    path for B=1 (18 rows over 8 blocks pad to 24, 36 to 40). Every seed's
    first stage tracks the mesh-free run's, as in tests/test_parallel.py:
    the renders are equal, the gradients to rounding (the row blocks' adjoint
    sums reassociate), which Adam and the plateau machine amplify over the
    later stage, so its end is held to converging comparably."""
    from xvr_tpu_torch.registrar import RegistrarFixed

    monkeypatch.setenv("XVR_FORCE_SHEARWARP", "1")
    volpath, xray = _xray(tmp_path, 36, 5.0)
    calls, passes = [], []
    orig = pmesh.ray_sharded_fast_render

    def spy(mesh, projector, pose, **kw):
        calls.append((int(pose.matrix.shape[0]), projector.detector.height))
        return orig(mesh, projector, pose, **kw)

    monkeypatch.setattr(pmesh, "ray_sharded_fast_render", spy)
    orig_pass = RegistrarFixed.run_test_time_optimization

    def kept_pass(reg, *a, **k):
        out = orig_pass(reg, *a, **k)
        passes.append([np.asarray(n, np.float64) for n in out[2]])  # per seed
        return out

    monkeypatch.setattr(RegistrarFixed, "run_test_time_optimization", kept_pass)

    def run(mesh):
        reg = RegistrarFixed(
            volume=volpath, mask=None, orientation="AP",
            rot=[np.pi, 0.0, 0.0], xyz=[0.0, 200.0, 0.0],
            linearize=False, scales="2,1", n_itrs="6,4",
            reverse_x_axis=False, lr_rot=5e-3, lr_xyz=1.0,
            max_n_plateaus=4, verbose=0, mesh=mesh, device="cpu",
            restart_seeds=seeds, max_restarts=0,
        )
        reg.run(xray, beta=1.0)
        return reg, passes.pop()

    reg, mesh_nccs = run(make_mesh(8, devices=CPU8))  # dp 4, rays 2
    assert reg.projector.renderer == "trilinear_fast"
    assert calls and {b for b, _ in calls} == {seeds} and {h for _, h in calls} == {18, 36}
    n_calls = len(calls)
    _, ref_nccs = run(None)
    assert len(calls) == n_calls  # the mesh-free run renders whole
    assert len(mesh_nccs) == len(ref_nccs) == seeds
    for m, r in zip(mesh_nccs, ref_nccs):
        np.testing.assert_allclose(m[:6], r[:6], atol=2e-3)
    best_m, best_r = max(m[-1] for m in mesh_nccs), max(r[-1] for r in ref_nccs)
    assert best_m > best_r - 0.05, (best_m, best_r)


def _trainer(volpath, outdir, mesh=None, **kw):
    args = dict(
        volpath=volpath, maskpath=None, outpath=outdir,
        sdd=400.0, height=32, delx=4.0, model_name="resnet18",
        batch_size=8, n_total_itrs=2, n_warmup_itrs=1,
        n_grad_accum_itrs=1, n_save_every_itrs=100, lr=1e-3,
        mesh=mesh, device="cpu", **RANGES,
    )
    args.update(kw)
    return Trainer(**args)


def test_mesh_rounds_batch_to_device_multiple(tmp_path, capsys):
    vol = _write_phantom(tmp_path)
    tr = _trainer(vol, tmp_path / "o", mesh=make_mesh(8, devices=CPU8), batch_size=10)
    assert tr.batch_size == 16 and tr.config["batch_size"] == 16
    assert "batch_size 10 -> 16 (multiple of 8 devices)" in capsys.readouterr().out


def _same_step(tr_ref, tr):
    """One step of each trainer on the same draws -> (metrics, metrics);
    the parameters after the update agree too."""
    draws = tr_ref.draw()
    m_ref = tr_ref.train_step(tr_ref.projectors[0], tr_ref.centers[0], draws)
    m = tr.train_step(tr.projectors[0], tr.centers[0], draws)
    for name, p in tr.params.items():
        np.testing.assert_allclose(p.detach().numpy(), tr_ref.params[name].detach().numpy(),
                                   rtol=5e-3, atol=5e-5, err_msg=name)
    return ({k: float(v) for k, v in m_ref.items()}, {k: float(v) for k, v in m.items()})


@pytest.mark.parametrize("route", ["golden", "shearwarp"])
def test_dp_sharded_step_matches_single_device(tmp_path, monkeypatch, route, two_torch_threads):
    """Same draws => the sharded step's loss equals the mesh-free step's:
    the shear-warp strata split their poses over every slot, the golden
    renderer its rays over (dp, rays), the CNN its batch over every slot."""
    if route == "shearwarp":
        monkeypatch.setenv("XVR_FORCE_SHEARWARP", "1")
    vol = _write_phantom(tmp_path)
    tr_ref = _trainer(vol, tmp_path / "ref", seed=7)
    tr = _trainer(vol, tmp_path / "dp", mesh=make_mesh(4, devices=CPU8), seed=7)
    renderer = "trilinear_fast" if route == "shearwarp" else "trilinear"
    assert all(p.renderer == renderer for p in tr.projectors[0])
    assert all(c % 4 == 0 for c in tr.strata_counts)
    m_ref, m = _same_step(tr_ref, tr)
    assert np.isfinite(m["loss"])
    np.testing.assert_allclose(m["loss"], m_ref["loss"], rtol=2e-4)
    np.testing.assert_allclose(m["kept"], m_ref["kept"], atol=1e-6)


def test_mesh_masked_channel_step(tmp_path, monkeypatch, two_torch_threads):
    """Masked training under a mesh: the label-channel shear-warp render
    with its slab bounds splits its poses over the slots, and the step's
    loss equals the mesh-free step's."""
    monkeypatch.setenv("XVR_FORCE_SHEARWARP", "1")
    volpath = _write_phantom(tmp_path, mask=True)
    mask = tmp_path / "mask.nii.gz"
    tr_ref = _trainer(volpath, tmp_path / "ref", maskpath=mask, seed=5)
    tr = _trainer(volpath, tmp_path / "mesh", maskpath=mask, mesh=make_mesh(2, devices=CPU8),
                  seed=5)
    assert tr.labels == (1,) and tr.projectors[0][0].shearwarp_bounds is not None
    assert all(p.renderer == "trilinear_fast" for p in tr.projectors[0])
    m_ref, m = _same_step(tr_ref, tr)
    assert np.isfinite(m["loss"]) and np.isfinite(m["dice"])
    np.testing.assert_allclose(m["loss"], m_ref["loss"], rtol=2e-4)
