"""A biplane pair, a frontal and a lateral X-ray whose views march different
volume axes, registered as one batch: the registrar gives each march axis
an optimization of its own (``RegistrarBase._run_batch``), with the
renderer chosen afresh from the configured one for each.

On the CPU (``XVR_FORCE_SHEARWARP=1``: the shear-warp route through K1-K4's
plain versions, here at the kernels' float32 arithmetic, ``bf16=False``),
through the benchmark's ``register_biplane`` driver at a small size (the
seeded vessel volume at 64^3, 128^2 X-rays, scales 4,2, a few iterations):
the scene is its seeds'; the pair through ``register_files`` ends each X-ray
where registering it alone does, bit for bit, every stage on
``trilinear_fast`` at the X-ray's own permutation, and the counter
``register.perm_groups`` counts the optimizations; the similarity the
registrar reports matches ``portbench/reference_biplane.py``'s; and the
benchmark's count of the work adds up over the pair's optimizations.

On the card (``-m gpu``): K1-K4 at the cell's finest stage (4 poses at
960^2, a 1024^2 slope grid) on the 512^3 vessel volume against their plain
versions at ``chip_smoke.py``'s tolerances, frontal and lateral; and the
pair through the graphed registrar against the two single runs, bit for
bit.
"""

from __future__ import annotations

import copy
import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import counts, harness
from portbench import scene
from portbench import scene_biplane as sb
from xvr_tpu_torch.render import shearwarp as sw
from xvr_tpu_torch.utils import profiling
from torch_threads import two_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SEED, FIDUCIALS = 20261020, 3000000123


def _cell(n=64, xray=128, scales="4,2", n_itrs="5,5", warmup=1) -> dict:
    c = copy.deepcopy(harness.cell("register.biplane"))
    cfg, tr = c["config"], c["traffic"]
    cfg["ct"]["size"] = n
    cfg["xray"].update(size=xray, spacing=0.154 * 1920 / xray)
    cfg["registrar"].update(scales=scales, n_itrs=n_itrs, verbose=0)
    tr.update(pool=4, warmup_itrs=warmup)
    return c


def _work(c, tmp, device):
    work = harness.driver("register_biplane").Work(c["config"], c["traffic"], FIDUCIALS, device)
    work.dir = Path(tmp) / "subject"
    work.setup()
    return work


def _counted(work, request, r):
    """One request through the driver -> (its record, the counters)."""
    profiling.reset()
    work._serve_one(request, r)
    return work.records[-1], profiling.snapshot()["counters"]


def _final(work, rec):
    work_records, work.records = work.records, [rec]
    try:
        return [final for _, _, final, _ in work._answers()]
    finally:
        work.records = work_records


@pytest.fixture(scope="module")
def biplane(tmp_path_factory):
    """The driver's subject and registrar on the CPU; then the frontal X-ray
    alone, the pair (lateral first) and the lateral alone, each counted."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XVR_FORCE_SHEARWARP", "1")
        for name in ("_accumulate", "_accumulate_adjoint", "_warp_plain", "_warp_with_grads_plain"):
            mp.setattr(sw, name, functools.partial(getattr(sw, name), bf16=False))
        profiling.enable()
        try:
            work = _work(_cell(), tmp_path_factory.mktemp("biplane"), "cpu")
            frontal, lateral = (0, work.inits[0]), (2, work.inits[2])
            runs = {}
            runs["frontal"] = _counted(work, [frontal], 0)
            runs["pair"] = _counted(work, [lateral, frontal], 1)
            runs["lateral"] = _counted(work, [lateral], 2)
            checks, info = work.check()
            yield work, runs, (checks, info)
        finally:
            profiling.enable(False)
            profiling.reset()


def test_the_scene_is_its_seeds():
    hu, aff, fids = sb.build_vessels(64, SEED, "cpu", fiducial_seed=FIDUCIALS)
    hu2, aff2, fids2 = sb.build_vessels(64, SEED, "cpu", fiducial_seed=FIDUCIALS)
    assert torch.equal(hu, hu2) and np.array_equal(aff, aff2) and np.array_equal(fids, fids2)
    _, _, other = sb.build_vessels(64, SEED, "cpu", fiducial_seed=FIDUCIALS + 1)
    assert not np.array_equal(fids, other)
    assert not torch.equal(hu, sb.build_vessels(64, SEED + 1, "cpu")[0])
    # a subtracted angiogram: air at -1000 HU, contrast near +500 HU
    assert int(hu.min()) == -1000 and 450 <= int(hu.max()) <= 600
    assert 0.0 < float((hu > -1000).float().mean()) < 0.2
    # the fiducials lie in vessels
    vox = np.round((fids - aff[:3, 3]) / np.diag(aff)[:3]).astype(int)
    assert fids.shape == (60, 3)
    assert bool((hu[vox[:, 0], vox[:, 1], vox[:, 2]] > -1000).all())


def test_the_pool_marches_two_axes():
    from portbench import reference as ref

    c = _cell()
    rot, xyz = sb.draw_views(np.random.default_rng(1), 8, c["traffic"]["views"])
    aff = np.diag([0.4, 0.4, 0.4, 1.0])
    axes = [ref.permutation(scene.poses(rot[i], xyz[i], "cpu"), np.linalg.inv(aff))[0]
            for i in range(8)]
    assert axes == [1] * 4 + [0] * 4
    assert (np.abs(xyz[:, [0, 2]]) <= 25.0).all() and ((xyz[:, 1] >= 700) & (xyz[:, 1] <= 800)).all()


def test_the_pair_ends_where_each_view_alone_ends(biplane):
    work, runs, _ = biplane
    pair = _final(work, runs["pair"][0])
    lateral, frontal = _final(work, runs["lateral"][0])[0], _final(work, runs["frontal"][0])[0]
    assert np.array_equal(pair[0], lateral) and np.array_equal(pair[1], frontal)


def test_every_stage_marches_its_own_axis(biplane):
    work, runs, _ = biplane
    for name, (rec, _) in runs.items():
        assert {st["renderer"] for st in rec["stages"]} == {"trilinear_fast"}, name
    axes = [st["perm"][0] for st in runs["pair"][0]["stages"]]
    half = len(axes) // 2  # the lateral X-ray's optimization first, in the request's order
    assert axes == [0] * half + [1] * half
    assert {st["perm"] for st in runs["frontal"][0]["stages"]} == {runs["pair"][0]["stages"][-1]["perm"]}


def test_perm_groups_count_the_optimizations(biplane):
    _, runs, _ = biplane
    assert runs["pair"][1]["register.perm_groups"] == 2
    assert runs["frontal"][1]["register.perm_groups"] == 1
    assert runs["lateral"][1]["register.perm_groups"] == 1


def test_the_renderer_is_chosen_afresh(biplane):
    """After a frontal X-ray's optimization left a shear-warp projector,
    a batch that shear-warp declines (the pair's mean rotation marches
    across the lateral view) falls to the golden renderer, never to the
    previous batch's permutation."""
    work, runs, _ = biplane
    reg = work.reg
    assert reg.projector.renderer == "trilinear_fast"
    from xvr_tpu_torch.geometry import RigidTransform

    pose = RigidTransform(torch.cat([work.gt[0:1], work.gt[2:3]]))
    scales = [4.0, 2.0]
    reg._upgrade_renderer(scales, pose, reg.projector.oriented_rotations(pose))
    assert reg.projector.renderer == "trilinear" and reg.projector.pallas_perm is None


def test_the_reported_similarity_and_the_render_are_the_references(biplane):
    _, _, (checks, info) = biplane
    assert set(checks) == {"mpd_max_mm", "render_gap"}  # the similarity is reported beside
    assert info["sim_gap_max"] <= 1e-4
    assert checks["render_gap"]["value"] <= 1e-5
    # the renders checked are those of the kernels each optimization chose
    assert info["renderers"] == ["trilinear_fast"] and len(info["render_gap"]) == info["xrays"]
    # each X-ray ends nearer its view than it began, by the fiducials' projections
    assert all(a < b for a, b in zip(info["mpd_mm"], info["mpd_init_mm"]))


def test_a_mixed_pair_on_a_mesh_pads_each_optimization(biplane):
    """On a 4-slot mesh each optimization of the pair is padded to the mesh
    on its own (one X-ray of 4 restart seeds: 4 copies, 16 poses a stage,
    every stage batch-sharded), and ends where that X-ray registered alone
    on the mesh ends, bit for bit."""
    from xvr_tpu_torch.parallel.mesh import make_mesh

    work, _, _ = biplane
    mesh = make_mesh(4, rays=1, devices=[torch.device("cpu")] * 4)
    drv = harness.driver("register_biplane")
    saved = work.reg, work.records
    work.reg = drv.registrar_class()(str(work.dir / "ct.nii"), None, "AP", device="cpu",
                                     mesh=mesh, **work.config["registrar"])
    try:
        frontal, lateral = (1, work.inits[1]), (3, work.inits[3])
        pair, counted = _counted(work, [frontal, lateral], 10)
        singles = [_counted(work, [v], 11 + j)[0] for j, v in enumerate((frontal, lateral))]
    finally:
        work.reg, work.records = saved
    S = int(work.config["registrar"]["restart_seeds"])
    assert counted["register.perm_groups"] == 2
    assert {st["K"] for rec in [pair, *singles] for st in rec["stages"]} == {mesh.size * S}
    got = _final(work, pair)
    want = [_final(work, rec)[0] for rec in singles]
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_the_work_counted_adds_over_the_views(biplane):
    work, runs, _ = biplane

    def work_of(recs):
        saved = work.records
        work.records = list(recs)
        try:
            return counts.window_work(work.context())
        finally:
            work.records = saved

    pair = work_of([runs["pair"][0]])
    single = [work_of([runs[k][0]]) for k in ("lateral", "frontal")]
    saved, work.records = work.records, [runs["pair"][0]]
    try:
        entries = work.context()["requests"]
    finally:
        work.records = saved
    assert [len(e["gt"]) for e in entries] == [1, 1]
    for key in ("n_done", "xrays"):
        assert pair[key] == single[0][key] + single[1][key], key
    for key in ("bound_s", "ops"):
        assert pair[key] == pytest.approx(single[0][key] + single[1][key], rel=1e-12), key


def test_the_benchmark_files_of_the_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == "register.biplane")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    r = cfg["registrar"]
    assert (r["labels"], r["crop"], r["linearize"], r["scales"], r["n_itrs"]) == (
        None, 0, True, "16,8,4,2", "500,500,500,100")
    assert r["restart_seeds"] == 4 and cfg["xray"]["size"] * cfg["xray"]["spacing"] == pytest.approx(
        128 * 2.31)
    c = harness.cell("register.biplane")
    assert {m["name"] for m in c["end_to_end"]} == {"register_s", "setup_s"}
    for m in c["per_layer"]:
        assert callable(harness.reader(m["name"]).read)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m gpu` on the card")
    return torch.device("cuda")


def _smoke():
    path = ROOT / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_biplane", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
@pytest.mark.parametrize("view", ["frontal", "lateral"])
def test_kernels_at_the_fine_stage_on_the_vessel_volume(cuda, view):
    """K1-K4 at 4 poses of 960^2 (a 1024^2 slope grid) on the 512^3 vessel
    volume, against their plain versions (chip_smoke.check_sw_stage: K1 in
    float64, K4 at the kernel's float32 positions; eps 1.0 and 0.25; the
    content skip against whole-slab boxes and repeated calls, bit for
    bit)."""
    from xvr_tpu_torch.geometry import convert
    from xvr_tpu_torch.render import Projector, Volume

    smoke = _smoke()
    hu, aff, _ = sb.build_vessels(512, SEED, cuda)
    vol = Volume(data=hu.float(), affine=torch.as_tensor(aff, dtype=torch.float32, device=cuda))
    proj = Projector.from_volume(vol, sdd=1250.0, height=1920, delx=0.154)
    rng = np.random.default_rng(4)
    r1 = 0.0 if view == "frontal" else 90.0
    rot = np.deg2rad(np.array([r1, 2.0, -3.0]) + rng.uniform(-1, 1, (4, 3)))
    xyz = np.array([10.0, 750.0, -12.0]) + rng.uniform(-4, 4, (4, 3))
    pose = convert(torch.tensor(rot, dtype=torch.float32, device=cuda),
                   torch.tensor(xyz, dtype=torch.float32, device=cuda), "euler_angles", "ZXY")
    fast = proj.with_shearwarp(pose)
    assert fast.renderer == "trilinear_fast" and fast.pallas_perm[0] == (1 if view == "frontal" else 0)
    fine = fast.rescale_detector(2.0)
    assert (fine.detector.height, sw.default_grid_shape((960, 960))) == (960, (1024, 1024))
    x, k1, ibar, errs, _ = smoke.check_sw_stage(fine.prepare_for_shearwarp(), fine, pose,
                                                f"biplane {view} B=4")
    assert float(k1.abs().max()) > 0 and all(np.isfinite(v) for v in errs.values())


@pytest.mark.gpu
def test_the_pair_on_the_card_is_the_single_runs(cuda, tmp_path):
    """The pair through the graphed registrar ends each X-ray where its
    single run does, bit for bit, each optimization replaying graphs of its
    own permutation."""
    c = _cell(n=128, xray=1920, scales="16,8,4,2", n_itrs="20,20,20,10", warmup=2)
    work = _work(c, tmp_path, "cuda")
    frontal, lateral = (1, work.inits[1]), (3, work.inits[3])
    profiling.enable()
    try:
        pair, counted = _counted(work, [frontal, lateral], 0)
        singles = [_counted(work, [v], i + 1)[0] for i, v in enumerate((frontal, lateral))]
    finally:
        profiling.enable(False)
        profiling.reset()
    assert counted["register.perm_groups"] == 2
    assert counted["register.graph_replays"] == counted["register.iterations"]
    assert {st["renderer"] for st in pair["stages"]} == {"trilinear_fast"}
    got = _final(work, pair)
    want = [_final(work, s)[0] for s in singles]
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
