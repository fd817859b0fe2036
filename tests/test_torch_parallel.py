"""The port's multi-device refinement (`intrinsic3d_torch.parallel`) against
the JAX package's, on the CPU.

The port's ranks are real processes joined over gloo on CPU tensors: one
launch per world size (2 and 4) through the package's launcher
(`parallel.dryrun.launch`, a `file://` rendezvous under the test's temporary
directory) runs every rank-side check of this module and returns the
results; the JAX side runs here on conftest's 8 virtual CPU devices with
`make_mesh(n)`. Inputs are the JAX package's arrays (`np.asarray`): the
perturbed sphere problem of `__graft_entry__._small_problem`, its block
problem (`to_block_problem`) and its level, the sphere capture of
`tests/test_spmd_stages.py` (rendered by the port, as numpy, for both).

Tolerances, each with its reason:
- halo plans: equal tables (the same numpy code on the same neighbour
  tables); `ShardedPlan.apply` exact and `apply_transpose` to 1e-12 against
  the single-device `ShiftPlan` in float64 (gathers, and sums of at most a
  few terms in another order), the adjoint identity to 1e-9 relative;
- `spmd_gn_iteration` against JAX's `spmd_gn_iteration`: costs rtol 1e-4
  (the JAX dry run's bar; measured ≤ 9e-6);
- `optimize_level(mesh=)`, dense and frame-bucketed, against JAX's
  `optimize_level(mesh=make_mesh(2))` at the dry run's settings:
  `costs_before` rtol 1e-4, `costs_after` rtol 1e-3 (the JAX dry run's own
  bars between its sharded and single-device runs). JAX's mesh run is taken
  at 2 devices for both world sizes: its sharded step is the same
  computation for any mesh size (its dry run pins every size to its
  single-device run at these bars);
- the Schur-eliminated sharded step against the PORT's single-device Schur
  step, rtol 2e-2: JAX's own sharded Schur solve does not hold its
  single-device one (measured on this problem's 3-frame twin,
  `tests/test_schur.py -k spmd`: second-iteration costs 0.559255 against
  0.511411, 9.4% apart, where that test's bar is 2e-2), so it cannot serve
  as the reference;
- sharded SVSH coefficients against JAX's `estimate_svsh`: rtol 2e-3,
  atol 2e-5 (the JAX stage test's bar: the all-reduced normal equations
  sum in another order, and the PCG runs at the float32 noise floor);
- sharded recolor against JAX's `_recolor_sweep`: flags equal, colors
  atol 1e-2 on the 0..255 scale (pixel coordinates one ulp apart move a
  bilinear tap by up to ~1e-3 of the image's range; the single-device
  port's bar in `tests/test_torch_refinement.py`);
- `Intrinsic3D(mesh=)` on the 2-grid-level schedule of
  `test_intrinsic3d_mesh_level_loop_sharded` against the port's
  single-device engine on the same fused grid: the same voxels, each
  level's first cost rtol 1e-3, refined SDF rtol 5e-3 atol 5e-5 (the JAX
  test's bar); every per-voxel placement record at most 1/n + 0.02 of its
  field;
- `FusionVolume(mesh=)` against JAX's `FusionVolume`: the same voxels, sdf
  atol 1e-6, weight rtol 1e-5, color atol 1e-3 (the single-device port's
  bars in `tests/test_torch_fusion.py`).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from intrinsic3d_tpu.camera import Camera as JCamera
from intrinsic3d_tpu.grid.blocks import BlockLayout as JBlockLayout
from intrinsic3d_tpu.grid.fusion import FusionVolume as JFusionVolume
from intrinsic3d_tpu.grid.fusion import compute_scene_voxel_bounds as j_scene_bounds
from intrinsic3d_tpu.grid.voxel_grid import NORMAL_OFFSETS
from intrinsic3d_tpu.lighting.svsh import estimate_svsh as j_estimate_svsh
from intrinsic3d_tpu.parallel.halo import build_halo_plan as j_build_halo_plan
from intrinsic3d_tpu.parallel.sharding import make_mesh
from intrinsic3d_tpu.parallel.spmd import spmd_gn_iteration as j_spmd_gn_iteration
from intrinsic3d_tpu.refine.blockform import layout_plans as j_layout_plans
from intrinsic3d_tpu.refine.blockform import to_block_problem as j_to_block_problem
from intrinsic3d_tpu.refine.intrinsic3d import _recolor_sweep as j_recolor_sweep
from intrinsic3d_tpu.refine.optimizer import optimize_level as j_optimize_level
from intrinsic3d_tpu.synthetic import build_sphere_problem as j_build_sphere_problem

from intrinsic3d_torch.grid.blocks import BlockLayout
from intrinsic3d_torch.parallel import dryrun
from intrinsic3d_torch.parallel.halo import build_halo_plan
from intrinsic3d_torch.refine.blockform import layout_plans

WORLD_SIZES = (2, 4)
MODES = ("never", "always")
SVSH = dict(subvolume_size=0.12, lambda_reg=10.0, num_best=2)


def _jax_problem():
    """`__graft_entry__._small_problem`."""
    from intrinsic3d_tpu.config import RefinementConfig as JRefinementConfig

    cfg = JRefinementConfig(num_observations=2, occlusion_distance=0.04, fix_poses=False, fix_intrinsics=False,
                            fix_distortion=False)
    return j_build_sphere_problem(voxel_size=0.015, image_size=(64, 48), num_frames=2, num_observations=2, cfg=cfg,
                                  perturb_sdf=0.002, perturb_albedo=0.05)


def _grid_dict(g) -> dict:
    return dict(voxel_size=float(g.voxel_size), coords=np.asarray(g.coords), sdf=np.asarray(g.sdf),
                weight=np.asarray(g.weight), color=np.asarray(g.color),
                albedo=None if g.albedo is None else np.asarray(g.albedo),
                sdf_refined=None if g.sdf_refined is None else np.asarray(g.sdf_refined))


def _pipeline_cfg(jcfg, mode):
    return dataclasses.replace(jcfg, iterations=2, lm_steps=4, frame_bucketing=mode, lambda_r0=20.0, lambda_r1=20.0,
                               lambda_s0=20.0, lambda_s1=20.0, schur_globals=False)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX problem's inputs as numpy, and the JAX multi-device results."""
    prob = _jax_problem()
    grid = prob.grid
    grid.sdf_refined = np.asarray(prob.params.sdf).astype(np.float32)
    grid.albedo = np.asarray(prob.params.albedo).astype(np.float32)
    asm, masks = prob.assemble()
    fields = ("eg_w", "eg_sh", "eg_vpos", "er_w", "es_ref", "es_w", "ea_w", "lam", "images", "pyr_scale",
              "voxel_size", "bmap")
    bprob, spmd = {}, {}
    for n in WORLD_SIZES:
        layout = JBlockLayout.build(grid, blocks_multiple=n)
        bp, basm, bm = j_to_block_problem(layout, prob.topo.coords, asm, masks, prob.params, num_obs=2)
        bprob[n] = dict(
            grid=_grid_dict(grid), blocks_multiple=n, bp=[np.asarray(a) for a in bp], bm=[np.asarray(a) for a in bm],
            basm={k: None if getattr(basm, k) is None else np.asarray(getattr(basm, k)) for k in fields},
        )
        out = j_spmd_gn_iteration(bp, basm, bm, jnp.float32(1e-4), layout, make_mesh(n), lm_steps=3, cg_iters=4)
        spmd[n] = (float(out[1]), float(out[2]))

    images = np.asarray(prob.images)
    colors_u8 = np.clip(np.stack([images] * 3, axis=-1) * 255.0, 0, 255).astype(np.uint8)
    cam = prob.cam
    level = dict(
        grid=_grid_dict(grid), params=[np.asarray(a) for a in prob.params], cfg=dataclasses.asdict(prob.cfg),
        cam=dict(fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx), cy=float(cam.cy), width=int(cam.width),
                 height=int(cam.height)),
        depths=np.asarray(prob.depths), images=images, voxel_sh=np.asarray(prob.voxel_sh, np.float32),
        thres_shell=float(prob.thres_shell), colors_u8=colors_u8,
    )
    pipeline = {}
    for mode in MODES:
        args = (grid, prob.topo, prob.params, _pipeline_cfg(prob.cfg, mode), prob.cam, prob.depths, prob.images,
                prob.voxel_sh, prob.thres_shell)
        _, _, st = j_optimize_level(*args, rgbd_level=0, cg_iters=4, mesh=make_mesh(2))
        pipeline[mode] = st

    svsh = j_estimate_svsh(grid, SVSH["subvolume_size"], SVSH["lambda_reg"], prob.thres_shell)
    cols, has = j_recolor_sweep(
        prob.params.sdf, jnp.asarray(grid.neighbor_table(NORMAL_OFFSETS)), jnp.asarray(grid.valid_mask()),
        jnp.asarray(grid.voxel_to_world()), prob.params.poses, prob.params.intr, prob.params.dist, prob.depths,
        jnp.asarray(colors_u8), jnp.float32(prob.cfg.occlusion_distance), num_best=SVSH["num_best"],
        width=cam.width, height=cam.height,
    )

    scene = dryrun.sphere_scene()
    sc = scene["cam"]
    jcam = JCamera.create(sc["fx"], sc["fy"], sc["cx"], sc["cy"], sc["width"], sc["height"])
    vlo, vhi = j_scene_bounds(jcam, list(scene["poses"]), scene["depth_min"], scene["depth_max"], 0.02)
    vol = JFusionVolume(jcam, jcam, 0.02, vlo, vhi, scene["depth_min"], scene["depth_max"])
    vol.allocate_batch(scene["depths"], scene["poses"])
    vol.build_grid()
    vol.integrate_batch(scene["depths"], scene["colors"], scene["poses"])
    fused = vol.finalize()
    return dict(
        prob=prob, bprob=bprob, spmd=spmd, level=level, pipeline=pipeline, svsh=svsh.coeffs,
        recolor=(np.asarray(cols), np.asarray(has)), scene=scene,
        fusion=dict(coords=np.asarray(fused.coords), sdf=fused.sdf, weight=fused.weight, color=fused.color),
    )


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """Every rank's results of one launch per world size."""
    tmp = tmp_path_factory.mktemp("ranks")
    out = {}
    for n in WORLD_SIZES:
        calls = [
            ("halo", dryrun.halo_task, (jax_side["bprob"][n],), {}),
            ("spmd", dryrun.spmd_step_task, (jax_side["bprob"][n],), {}),
            ("schur", dryrun.spmd_step_task, (jax_side["bprob"][n],), dict(schur=True, cg_coeff_dtype="float32")),
            ("pose_schur", dryrun.spmd_step_task, (jax_side["bprob"][n],),
             dict(schur="poses", cg_coeff_dtype="float32")),
            ("pipeline", dryrun.pipeline_task, (jax_side["level"],), dict(single=False)),
            ("stages", dryrun.stages_task, (jax_side["level"],), SVSH),
            ("fusion", dryrun.fusion_task, (jax_side["scene"],), {}),
            ("mesh_loop", dryrun.mesh_loop_task, (jax_side["scene"], dryrun.MESH_LOOP_CFG), {}),
        ]
        out[n] = dryrun.launch(dryrun.run_tasks, n, backend="gloo", device="cpu",
                               init_method=f"file://{tmp}/rendezvous{n}", args=(calls,), timeout=600.0)
    return out


@pytest.mark.parametrize("n", (2, 4, 8))
def test_halo_plan_tables_match_jax(n):
    """`build_halo_plan` on the port's gather-form plans gives JAX's tables
    on JAX's plans of the same layout."""
    prob = _jax_problem()
    jlayout = JBlockLayout.build(prob.grid, blocks_multiple=n)
    layout = BlockLayout.build(dryrun._grid(_grid_dict(prob.grid)), blocks_multiple=n)
    want = j_build_halo_plan(jlayout.num_blocks, n, [np.asarray(p.nbr) for p in j_layout_plans(jlayout)])
    got = build_halo_plan(layout.num_blocks, n, [p.nbr.numpy() for p in layout_plans(layout, "cpu")])
    assert (got.n, got.m, got.shifts, got.hs) == (want.n, want.m, want.shifts, want.hs)
    for a, b in zip(got.send + got.nbr_local, want.send + want.nbr_local):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_sharded_plan_matches_shift_plan(ranks, n):
    for rank in ranks[n]:
        for name, r in rank["halo"].items():
            assert r["apply_err"] == 0.0, name
            assert r["transpose_err"] <= 1e-12, name
            lhs, rhs = r["adjoint"]
            assert abs(lhs - rhs) <= 1e-9 * abs(lhs), (name, lhs, rhs)


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_spmd_gn_iteration_matches_jax(ranks, jax_side, n):
    got = ranks[n][0]["spmd"]["spmd"]
    np.testing.assert_allclose((got["cost0"], got["cost1"]), jax_side["spmd"][n], rtol=1e-4)
    assert got["cost1"] < got["cost0"]


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_spmd_schur_matches_single_device_schur(ranks, n):
    """The sharded Schur-eliminated step against the port's own
    single-device Schur step (module docstring: why not JAX's)."""
    r = ranks[n][0]["schur"]
    sp, one = r["spmd"], r["single"]
    np.testing.assert_allclose((sp["cost0"], sp["cost1"]), (one["cost0"], one["cost1"]), rtol=2e-2)
    assert sp["tries"] == one["tries"]


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_spmd_pose_schur_matches_single_device(ranks, n):
    """The sharded step with the poses eliminated and the camera's
    intrinsics and distortion in the PCG (replicated leaves, counted once in
    its inner products) against the port's single-device step of the same
    kind, as the whole block's above."""
    r = ranks[n][0]["pose_schur"]
    sp, one = r["spmd"], r["single"]
    np.testing.assert_allclose((sp["cost0"], sp["cost1"]), (one["cost0"], one["cost1"]), rtol=2e-2)
    assert sp["tries"] == one["tries"]
    np.testing.assert_allclose(sp["params"][3], one["params"][3], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_every_rank_holds_the_same_step(ranks, n):
    """Replicated results agree bit for bit across ranks, and every rank
    called the same collectives (a rank that skipped one would have hung)."""
    first = ranks[n][0]
    for other in ranks[n][1:]:
        for key in ("spmd", "schur", "pose_schur"):
            a, b = first[key]["spmd"], other[key]["spmd"]
            assert (a["cost0"], a["cost1"], a["mu"], a["tries"]) == (b["cost0"], b["cost1"], b["mu"], b["tries"])
            for pa, pb in zip(a["params"], b["params"]):
                np.testing.assert_array_equal(pa, pb)
            assert first[key]["collectives"] == other[key]["collectives"]
        np.testing.assert_array_equal(first["stages"]["coeffs"], other["stages"]["coeffs"])


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("mode", MODES)
def test_optimize_level_mesh_matches_jax(ranks, jax_side, n, mode):
    got = ranks[n][0]["pipeline"][mode]["mesh"]
    want = jax_side["pipeline"][mode]
    np.testing.assert_allclose(got["costs_before"], want.costs_before, rtol=1e-4)
    np.testing.assert_allclose(got["costs_after"], want.costs_after, rtol=1e-3)
    if mode == "always":
        assert got["bucket_blocks"] > 0


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_sharded_svsh_matches_jax(ranks, jax_side, n):
    got = ranks[n][0]["stages"]
    np.testing.assert_allclose(got["coeffs"], jax_side["svsh"], rtol=2e-3, atol=2e-5)
    for name, frac in got["fractions"].items():
        assert frac == pytest.approx(1.0 / n), name


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_sharded_recolor_matches_jax(ranks, jax_side, n):
    got = ranks[n][0]["stages"]
    want_cols, want_has = jax_side["recolor"]
    np.testing.assert_array_equal(got["has"], want_has)
    np.testing.assert_allclose(got["colors"][want_has], want_cols[want_has], atol=1e-2)


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_intrinsic3d_mesh_tracks_single_device(ranks, n):
    r = ranks[n][0]["mesh_loop"]
    got, ref = r["mesh"], r["single"]
    np.testing.assert_array_equal(got["coords"], ref["coords"])
    assert [lv["level"] for lv in got["levels"]] == [lv["level"] for lv in ref["levels"]] == ["g1p0", "g0p0"]
    for a, b in zip(got["levels"], ref["levels"]):
        np.testing.assert_allclose(a["costs_before"][0], b["costs_before"][0], rtol=1e-3)
    np.testing.assert_allclose(got["sdf_refined"], ref["sdf_refined"], rtol=5e-3, atol=5e-5)
    d = np.abs(got["color"] - ref["color"])
    assert np.percentile(d, 99) < 2.0  # 0..255 scale


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_intrinsic3d_mesh_placements_are_bricks(ranks, n):
    """Every per-voxel field the mesh level loop held, on every rank, is
    about 1/n of the field (its pad row aside)."""
    for rank in ranks[n]:
        levels = rank["mesh_loop"]["placements"]
        assert len(levels) == 3  # the initial recolor, then two grid levels
        for records in levels:
            assert records
            for name, total, mine in records:
                assert mine / total <= 1.0 / n + 0.02, (name, mine, total)


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_fusion_mesh_matches_jax(ranks, jax_side, n):
    got = ranks[n][0]["fusion"]["mesh"]
    want = jax_side["fusion"]
    np.testing.assert_array_equal(got["coords"], want["coords"])
    assert (got["weight"] > 0).sum() > 1000
    np.testing.assert_allclose(got["sdf"], want["sdf"], atol=1e-6)
    np.testing.assert_allclose(got["weight"], want["weight"], rtol=1e-5)
    np.testing.assert_allclose(got["color"], want["color"], atol=1e-3)
    for key in ("sdf", "weight", "color"):  # the port's own single-device fusion, bit for bit
        np.testing.assert_array_equal(got[key], ranks[n][0]["fusion"]["single"][key])

