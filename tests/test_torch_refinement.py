"""The port's level driver and the modules below it against the JAX package,
on the CPU.

Inputs are made with numpy from seeds (or the JAX package's own arrays, via
`np.asarray`) and passed to both packages. Tolerances, each with its reason:
- pyramids atol 1e-6: the same tap order, values O(1);
- normals atol 1e-6, iso points atol 1e-7 (values O(1) and O(0.1) m; the
  norm may round one ulp apart);
- observation weights atol 1e-6 (≤ 1), frame ids exact where the weight
  is > 0; recolored colors atol 1e-2 (0..255: pixel coordinates one ulp
  apart move a bilinear tap by up to ~1e-3 of the image's range; measured
  3.1e-3);
- subvolumes, thin-shell voxel sets, upsample and `interpolate_fields`,
  frame buckets and layout plans: exact (integer, boolean or the same numpy
  code); the first cost of a level run in each non-dense plan against JAX's
  device assembly and residual stack in that layout rtol 1e-4 (the JAX
  sampler's bf16 hi/lo split);
- SVSH coefficients and per-voxel SH rtol 1e-4 of the largest value: both
  PCGs run to their step limit at the float32 noise floor, with scatter-adds
  in another order (measured ≤ 2e-6);
- a level's outer iterations from the JAX level's recorded inputs at the
  JAX driver's settings (10 CG steps, η = 0.1, bf16 coefficients):
  costs and μ rtol 1e-3, tries equal, albedo atol 1e-3 and the other
  parameters atol 1e-5 (measured: costs 1.0e-5 and μ 1.7e-4 apart over 3
  iterations, albedo 3.7e-4, sdf 3.2e-6 — bf16 coefficients and a 10-step
  PCG amplify rounding);
- the whole refinement of the end-to-end scene: the same schedule, voxel
  sets and final voxel size; per-level costs rtol 1e-3 (measured 5.1e-5),
  refined SDF atol 1e-4 m and albedo atol 1e-3 on the common voxels
  (measured 1.2e-5 m and 4.0e-4);
  colors flip-tolerant (at most 0.5% of voxels more than 0.5 apart, the
  median under 1e-2): a voxel whose best observations tie or sit at the
  occlusion gate may pick another frame.

The JAX refinement of the end-to-end scene takes ~2 minutes of this file's
~3 (one worker), most of it XLA compiling one solver program per level.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsic3d_tpu.camera import Camera as JCamera
from intrinsic3d_tpu.config import RefinementConfig as JRefinementConfig
from intrinsic3d_tpu.grid import algorithms as j_alg
from intrinsic3d_tpu.grid import ops as j_gops
from intrinsic3d_tpu.grid.blocks import BlockLayout as JBlockLayout
from intrinsic3d_tpu.grid.voxel_grid import NORMAL_OFFSETS
from intrinsic3d_tpu.grid.voxel_grid import VoxelGrid as JVoxelGrid
from intrinsic3d_tpu.image.pyramid import depth_down as j_depth_down
from intrinsic3d_tpu.image.pyramid import pyr_down as j_pyr_down
from intrinsic3d_tpu.io.memory_sensor import MemorySensor as JMemorySensor
from intrinsic3d_tpu.lighting import svsh as j_svsh
from intrinsic3d_tpu.lighting.subvolumes import Subvolumes as JSubvolumes
from intrinsic3d_tpu.observations import collect_observations as j_collect_observations
from intrinsic3d_tpu.observations import compute_observation as j_compute_observation
from intrinsic3d_tpu.observations import recolor as j_recolor
from intrinsic3d_tpu.refine import blockform as j_bf
from intrinsic3d_tpu.refine import intrinsic3d as j_i3d
from intrinsic3d_tpu.refine import optimizer as j_opt
from intrinsic3d_tpu.refine.device_assembly import build_level_static as j_build_level_static
from intrinsic3d_tpu.refine.device_assembly import device_assembly as j_device_assembly
from intrinsic3d_tpu.refine.optimizer import plan_eg_layout as j_plan_eg_layout
from intrinsic3d_tpu.synthetic import build_sphere_problem as j_build_sphere_problem

from intrinsic3d_torch.apps import app_fusion
from intrinsic3d_torch.camera import Camera
from intrinsic3d_torch.config import FusionConfig, RefinementConfig
from intrinsic3d_torch.grid import algorithms as alg
from intrinsic3d_torch.grid import ops as gops
from intrinsic3d_torch.grid.blocks import BlockLayout
from intrinsic3d_torch.grid.voxel_grid import VoxelGrid
from intrinsic3d_torch.image.pyramid import depth_down, pyr_down
from intrinsic3d_torch.io.memory_sensor import MemorySensor
from intrinsic3d_torch.lighting import svsh
from intrinsic3d_torch.lighting.subvolumes import Subvolumes
from intrinsic3d_torch.observations import collect_observations, compute_observation, recolor
from intrinsic3d_torch.refine import blockform as bf
from intrinsic3d_torch.refine import optimizer as opt
from intrinsic3d_torch.refine.intrinsic3d import Intrinsic3D
from intrinsic3d_torch.refine.residuals import Params
from intrinsic3d_torch.synthetic import (
    SMALL_CG_ITERS,
    SMALL_REFINEMENT,
    SMALL_VOXEL,
    build_sphere_problem,
    small_refinement_sensor,
)

PROBLEM = dict(
    voxel_size=0.015, image_size=(64, 48), num_frames=3, num_observations=2,
    perturb_sdf=0.002, perturb_albedo=0.05,
)
# three close views that each see a patch of the sphere: exact buckets halve
# the blocks (the planner's speed rule)
CLOSE_EYES = ([0.0, 0.0, 0.33], [0.05, 0.0, 0.34], [-0.05, 0.02, 0.34])
JAX_BYTES_PER_ELEMENT = 720  # the JAX planner's dense constant, pinned on both sides


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes: one intra-op
    thread per process keeps torch from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    kw = dict(dict(num_observations=2, occlusion_distance=0.04, fix_poses=False), **kw)
    return JRefinementConfig(**kw), RefinementConfig(**kw)


@pytest.fixture(scope="module")
def problems():
    jcfg, tcfg = _cfgs()
    return j_build_sphere_problem(**PROBLEM, cfg=jcfg), build_sphere_problem(**PROBLEM, cfg=tcfg, device="cpu")


def _jgrid(g: VoxelGrid) -> JVoxelGrid:
    c = lambda a: None if a is None else np.array(a)  # noqa: E731
    return JVoxelGrid(
        voxel_size=g.voxel_size, coords=c(g.coords), keys=c(g.keys), sdf=c(g.sdf), weight=c(g.weight),
        color=c(g.color), albedo=c(g.albedo), sdf_refined=c(g.sdf_refined), depth_min=g.depth_min,
        depth_max=g.depth_max, integration_weight_sample=g.integration_weight_sample,
    )


def _tgrid(g: JVoxelGrid) -> VoxelGrid:
    c = lambda a: None if a is None else np.array(a)  # noqa: E731
    return VoxelGrid(
        voxel_size=g.voxel_size, coords=c(g.coords), keys=c(g.keys), sdf=c(g.sdf), weight=c(g.weight),
        color=c(g.color), albedo=c(g.albedo), sdf_refined=c(g.sdf_refined), depth_min=g.depth_min,
        depth_max=g.depth_max, integration_weight_sample=g.integration_weight_sample,
    )


def _noisy_level_grid(tp, seed=3) -> VoxelGrid:
    """The sphere problem's shell with a noisy refined SDF, a tenth of the
    voxels invalid and varied colors."""
    rng = np.random.default_rng(seed)
    g = tp.grid.clone()
    n = g.num_voxels
    g.sdf_refined = (g.sdf + rng.normal(0.0, 0.002, n)).astype(np.float32)
    g.weight = np.where(rng.random(n) < 0.9, 1.0 + rng.random(n), 0.0).astype(np.float32)
    g.color = np.clip(g.color * rng.uniform(0.8, 1.2, (n, 3)), 0.0, 255.0).astype(np.float32)
    return g


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _jcam(cam: Camera) -> JCamera:
    return JCamera.create(cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height, np.asarray(cam.dist))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def test_pyramid_steps_match_jax():
    """`pyr_down` (color and gray stacks of odd size) and `depth_down`
    against the JAX functions vmapped over frames."""
    rng = np.random.default_rng(0)
    colors = rng.uniform(0.0, 1.0, (3, 37, 50, 3)).astype(np.float32)
    depth = rng.uniform(0.3, 2.0, (3, 37, 50)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.3] = 0.0
    for img in (colors, colors[..., 1]):
        want = np.stack([np.asarray(j_pyr_down(jnp.asarray(f))) for f in img])
        got = pyr_down(torch.as_tensor(img)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6)
    want = np.stack([np.asarray(j_depth_down(jnp.asarray(d))) for d in depth])
    got = depth_down(torch.as_tensor(depth)).numpy()
    assert got.shape == want.shape == (3, 18, 25)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_normals_and_iso_match_jax(problems):
    _, tp = problems
    g = _noisy_level_grid(tp)
    nbr4 = g.neighbor_table(NORMAL_OFFSETS)
    jn, jok = j_gops.surface_normals(jnp.asarray(g.sdf_refined), jnp.asarray(nbr4), jnp.asarray(g.valid_mask()))
    tn, tok = gops.surface_normals(_t(g.sdf_refined), _t(nbr4, torch.int64), _t(g.valid_mask(), torch.bool))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert 0.5 * g.num_voxels < int(tok.sum()) < g.num_voxels
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-6)
    pts = g.voxel_to_world()
    jiso = j_gops.voxel_center_to_iso(jnp.asarray(pts), jn, jnp.asarray(g.sdf_refined))
    tiso = gops.voxel_center_to_iso(_t(pts), tn, _t(g.sdf_refined))
    np.testing.assert_allclose(tiso.numpy(), np.asarray(jiso), atol=1e-7)


def test_observations_and_recolor_match_jax(problems):
    """`compute_observation` per frame, the best-2 `collect_observations`
    and the weighted `recolor` on the sphere problem's frames."""
    jp, tp = problems
    g = _noisy_level_grid(tp)
    nbr4 = g.neighbor_table(NORMAL_OFFSETS)
    jn, _ = j_gops.surface_normals(jnp.asarray(g.sdf_refined), jnp.asarray(nbr4), jnp.asarray(g.valid_mask()))
    jiso = j_gops.voxel_center_to_iso(jnp.asarray(g.voxel_to_world()), jn, jnp.asarray(g.sdf_refined))
    tn, tiso = _t(np.asarray(jn)), _t(np.asarray(jiso))
    colors = np.clip(np.stack([np.asarray(jp.images)] * 3, axis=-1) * 255.0, 0, 255).astype(np.uint8)
    occ = 0.04
    jcam, tcam = jp.cam, tp.cam
    tw_all, _ = compute_observation(tcam, tp.params.poses, tp.depths, tiso, tn, occ)
    for k in range(3):
        jw, _ = j_compute_observation(jcam, jp.params.poses[k], jp.depths[k], jiso, jn, occ)
        np.testing.assert_allclose(tw_all[k].numpy(), np.asarray(jw), atol=1e-6)
    jw, jf = j_collect_observations(jcam, jp.params.poses, jp.depths, jiso, jn, occ, num_best=2)
    tw, tf = collect_observations(tcam, tp.params.poses, tp.depths, tiso, tn, occ, num_best=2)
    jw, jf = np.asarray(jw), np.asarray(jf)
    np.testing.assert_allclose(tw.numpy(), jw, atol=1e-6)
    seen = jw > 0.0
    assert seen[:, 0].mean() > 0.3 and seen[:, 1].any()
    np.testing.assert_array_equal(tf.numpy()[seen], jf[seen])
    jc, jhas = j_recolor(jcam, jp.params.poses, jp.depths, jnp.asarray(colors), jiso, jn, jnp.asarray(jw),
                         jnp.asarray(jf), occ)
    tc, thas = recolor(tcam, tp.params.poses, torch.as_tensor(colors), tiso, _t(jw), _t(jf, torch.int32))
    np.testing.assert_array_equal(thas.numpy(), np.asarray(jhas))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-2)


def test_subvolumes_match_jax(problems):
    _, tp = problems
    pts = tp.grid.voxel_to_world()
    js, ts = JSubvolumes.compute(pts, 0.07), Subvolumes.compute(pts, 0.07)
    assert ts.count == js.count > 8
    np.testing.assert_array_equal(ts.indices, js.indices)
    np.testing.assert_array_equal(ts.keys, js.keys)
    np.testing.assert_array_equal(ts.point_to_subvolume(pts), js.point_to_subvolume(pts))
    np.testing.assert_array_equal(ts.neighbor_pairs(), js.neighbor_pairs())
    for a, b in zip(ts.cell_lookup(), js.cell_lookup()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ts.interpolation(pts), js.interpolation(pts)):
        np.testing.assert_array_equal(a, b)
    vals = np.random.default_rng(1).normal(size=(ts.count, 9))
    np.testing.assert_array_equal(ts.interpolate_values(vals, pts), js.interpolate_values(vals, pts))


def test_svsh_matches_jax(problems):
    """`estimate_svsh(with_voxel_sh=True)`: coefficients and per-voxel SH."""
    _, tp = problems
    g = _noisy_level_grid(tp)
    thres = 2.0 * g.voxel_size
    jres, jvox = j_svsh.estimate_svsh(_jgrid(g), 0.07, 10.0, thres, weighted=True, with_voxel_sh=True)
    tres, tvox = svsh.estimate_svsh(g, 0.07, 10.0, thres, weighted=True, with_voxel_sh=True, device="cpu")
    assert tres.subvolumes.count == jres.subvolumes.count > 8
    scale = np.abs(jres.coeffs).max()
    np.testing.assert_allclose(tres.coeffs, jres.coeffs, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(tvox, jvox, rtol=0, atol=1e-4 * scale)
    assert np.count_nonzero(np.any(tvox != 0.0, axis=1)) > 0.3 * g.num_voxels
    np.testing.assert_allclose(
        svsh.voxel_sh_coeffs(tres, g, thres), j_svsh.voxel_sh_coeffs(jres, _jgrid(g), thres), atol=1e-4 * scale
    )


def test_solve_block_system_matches_jax():
    rng = np.random.default_rng(5)
    s = 12
    m = rng.normal(size=(s, 9, 9)).astype(np.float32)
    a_blocks = (np.einsum("sij,skj->sik", m, m) * 0.05).astype(np.float32)
    b = rng.normal(size=(s, 9)).astype(np.float32)
    src = rng.integers(0, s, 30)
    dst = (src + rng.integers(1, s, 30)) % s
    pairs = np.stack([src, dst], -1).astype(np.int32)
    want = np.asarray(j_svsh.solve_block_system(jnp.asarray(a_blocks), jnp.asarray(b), jnp.asarray(pairs), s,
                                                jnp.float32(10.0)))
    got = svsh.solve_block_system(_t(a_blocks), _t(b), _t(pairs, torch.int64), s, 10.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def _shell_grid():
    """An irregular shell with invalid voxels, sign changes and support
    straddling block boundaries (the JAX package's own thin-shell case)."""
    rng = np.random.default_rng(11)
    r = np.arange(-10, 11)
    coords = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    coords = coords[np.abs(np.linalg.norm(coords, axis=1) - 7.0) < 3.5]
    g = VoxelGrid.from_coords(0.01, coords, sbr=True)
    g.weight[:] = (rng.random(g.num_voxels) > 0.1).astype(np.float32)
    g.sdf_refined[:] = (np.linalg.norm(g.coords, axis=1) - 7.0) * 0.01 + rng.normal(0, 0.002, g.num_voxels)
    g.sdf[:] = g.sdf_refined
    return g


# 0.015, and a threshold whose float32 rounding lies above it, with one
# voxel's |sdf| exactly at that float32 value: the host compares in float64
@pytest.mark.parametrize("thres", [0.015, 0.0041])
def test_thin_shell_routes_match_jax_host_route(thres):
    g = _shell_grid()
    if thres == 0.0041:
        assert float(np.float32(thres)) > thres
        g.sdf_refined[np.argmin(np.abs(np.abs(g.sdf_refined) - thres))] = np.float32(thres)
    want = j_alg.clear_voxels_outside_thin_shell(_jgrid(g), thres, use_device=False)
    assert 0 < want.num_voxels < g.num_voxels
    for dense in (False, True):
        got = alg.clear_voxels_outside_thin_shell(g, thres, dense=dense, device="cpu")
        np.testing.assert_array_equal(got.coords, want.coords, err_msg=f"dense={dense}")
        np.testing.assert_array_equal(got.sdf_refined, want.sdf_refined)


def test_upsample_and_interpolate_fields_bitwise():
    rng = np.random.default_rng(7)
    coords = np.unique(rng.integers(-5, 5, size=(300, 3)).astype(np.int32), axis=0)
    g = VoxelGrid.from_coords(0.01, coords, sbr=True)
    n = g.num_voxels
    g.sdf = rng.normal(size=n).astype(np.float32)
    g.weight = np.where(rng.random(n) < 0.75, rng.random(n).astype(np.float32) * 5, 0.0).astype(np.float32)
    g.color = rng.random((n, 3)).astype(np.float32)
    g.albedo = rng.random(n).astype(np.float32)
    g.sdf_refined = rng.normal(size=n).astype(np.float32)
    pos = rng.uniform(-5.5, 5.0, (500, 3))
    want = j_alg.interpolate_fields(_jgrid(g), pos)
    got = alg.interpolate_fields(g, pos)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    jup, tup = j_alg.upsample(_jgrid(g)), alg.upsample(g, device="cpu")
    assert tup.voxel_size == jup.voxel_size
    for f in ("coords", "keys", "sdf", "weight", "color", "albedo", "sdf_refined"):
        np.testing.assert_array_equal(getattr(tup, f), getattr(jup, f), err_msg=f)


# ---------------------------------------------------------------------------
# the level planner
# ---------------------------------------------------------------------------


def _plan_args(p, cfg, layout):
    w, h = int(p.images.shape[2]), int(p.images.shape[1])
    return (layout, np.asarray(p.params.poses), np.asarray(p.params.intr), cfg, w, h, p.grid.voxel_size,
            p.thres_shell, np.asarray(p.depths))


def test_frame_buckets_match_jax(problems):
    jp, tp = problems
    jl, tl = JBlockLayout.build(jp.grid), BlockLayout.build(tp.grid)
    assert tl.num_blocks == jl.num_blocks
    np.testing.assert_array_equal(tl.block_coords, jl.block_coords)
    base = dict(poses6=np.asarray(jp.params.poses), intr4=np.asarray(jp.params.intr), width=64, height=48,
                voxel_size=jp.grid.voxel_size)
    occl = dict(depths=np.asarray(jp.depths), occlusion=0.04)
    for kw in ({}, occl, dict(occl, max_frames_per_block=2),
               dict(occl, max_frames_per_block=3, max_blocks_per_frame=16, protect_cover=2)):
        js, ts = {}, {}
        want = j_bf.build_frame_buckets(jl, **base, **kw, **({"stats": js} if "protect_cover" in kw else {}))
        got = bf.build_frame_buckets(tl, **base, **kw, **({"stats": ts} if "protect_cover" in kw else {}))
        np.testing.assert_array_equal(got, want, err_msg=str(kw))
        assert ts == js
    for x in (1, 8, 9, 100, 1000, 5704):
        assert bf.bucket_ladder_up(x) == j_bf.bucket_ladder_up(x)
        assert bf.bucket_ladder_down(x) == j_bf.bucket_ladder_down(x)


def _jax_first_cost(jp, jcfg, jl, fb) -> float:
    """JAX's cost at the level's start in the element layout `fb` (None:
    dense): its device assembly at the first iteration's weights and the
    residual stack, as `optimize_level`'s first `costs_before`."""
    st = j_build_level_static(jl, jp.grid, jp.topo, jp.voxel_sh)
    sp, ap = j_bf.layout_plans(jl)
    bp = jp.params._replace(sdf=j_bf.table_to_dense(jl, jp.params.sdf),
                            albedo=j_bf.table_to_dense(jl, jp.params.albedo))
    scal = (1.0, jp.grid.voxel_size, jp.grid.truncation, jp.thres_shell, jcfg.occlusion_distance)
    lams = jnp.asarray([jcfg.lambda_g, jcfg.lambda_r0, jcfg.lambda_s0, jcfg.lambda_a], jnp.float32)
    asm, _ = j_device_assembly(
        st, sp, ap, bp, jp.depths, jp.images, *(jnp.float32(v) for v in scal), lams, num_obs=jcfg.num_observations,
        width=64, height=48, fix_poses=jcfg.fix_poses, fix_intrinsics=jcfg.fix_intrinsics,
        fix_distortion=jcfg.fix_distortion, bmap=None if fb is None else jnp.asarray(fb),
        min_pose_obs=jcfg.min_pose_obs,
    )
    r = np.asarray(jax.jit(j_bf.block_all_residuals)(bp, asm), np.float64)
    return 0.5 * float(np.sum(r * r))


@pytest.mark.parametrize("case", ["dense", "never", "speed", "always", "memory-forced", "streamed", "trimmed"])
def test_plan_eg_layout_matches_jax(problems, case, monkeypatch):
    """The same plan (bmap, reason, chunks) as the JAX planner at pinned
    budgets and with its memory constants pinned on both sides, one case per
    rule; the port's `optimize_level` runs the plan it makes there, and its
    first cost matches JAX's in that layout (rtol 1e-4: the JAX sampler's
    bf16 hi/lo split)."""
    jp, tp = problems
    kw = {"never": dict(frame_bucketing="never"), "always": dict(frame_bucketing="always")}.get(case, {})
    jcfg, tcfg = _cfgs(**kw)
    if case == "speed":
        jp = j_build_sphere_problem(**PROBLEM, cfg=jcfg, eyes=CLOSE_EYES)
        tp = build_sphere_problem(**PROBLEM, cfg=tcfg, eyes=CLOSE_EYES, device="cpu")
    for name in ("_EG_BUCKET_BYTES_PER_ELEMENT", "_EG_CHUNK_PERSIST_BYTES", "_EG_CHUNK_TRANSIENT_BYTES",
                 "_EG_ASSEMBLY_BYTES"):
        monkeypatch.setattr(opt, name, getattr(j_opt, name))
    jl, tl = JBlockLayout.build(jp.grid), BlockLayout.build(tp.grid)
    k, nb, s = 3, tl.num_blocks, tl.block**3
    exact = bf.build_frame_buckets(
        tl, np.asarray(jp.params.poses), np.asarray(jp.params.intr), 64, 48, jp.grid.voxel_size,
        margin_px=0.15 * 64, depths=np.asarray(jp.depths), occlusion=0.04, depth_slack=0.05 + jp.thres_shell,
    ).shape[1]
    budget = {
        "memory-forced": 0.99 * k * nb * s * JAX_BYTES_PER_ELEMENT,
        "streamed": 0.99 * k * exact * s * JAX_BYTES_PER_ELEMENT,
        "trimmed": 17 * k * s * 640,
    }.get(case, 1e18)
    want = j_plan_eg_layout(*_plan_args(jp, jcfg, jl), budget=budget, bytes_per_element=JAX_BYTES_PER_ELEMENT)
    got = opt.plan_eg_layout(*_plan_args(tp, tcfg, tl), budget=budget, bytes_per_element=JAX_BYTES_PER_ELEMENT,
                             device="cpu")
    assert got[1:] == want[1:]
    if want[0] is None:
        assert got[0] is None
    else:
        np.testing.assert_array_equal(got[0], want[0])
    expect = {"dense": "dense (full", "never": "dense (bucketing", "speed": "speed", "always": "forced by config",
              "memory-forced": "memory-forced", "streamed": "streamed in",
              "trimmed": "trimmed to 16 blocks/frame"}[case]
    assert expect in got[1], got[1]

    monkeypatch.setattr(opt, "plan_eg_layout", functools.partial(opt.plan_eg_layout,
                                                                 bytes_per_element=JAX_BYTES_PER_ELEMENT))
    tcfg = dataclasses.replace(tcfg, iterations=2)
    args = (tp.grid, tp.topo, tp.params, tcfg, tp.cam, tp.depths, tp.images, tp.voxel_sh, tp.thres_shell, 0)
    _, _, st = opt.optimize_level(*args, cg_iters=4, budget=budget, device="cpu")
    assert st.reason == got[1] and len(st.costs_after) == tcfg.iterations
    assert st.eg_chunks == got[2] and st.bucket_blocks == (0 if got[0] is None else got[0].shape[1])
    assert st.elements == k * (st.bucket_blocks or nb) * s
    assert st.costs_after[-1] < st.costs_before[0]
    if case not in ("dense", "never"):
        assert st.costs_before[0] == pytest.approx(_jax_first_cost(jp, jcfg, jl, got[0]), rel=1e-4)


# ---------------------------------------------------------------------------
# the level loop and the whole refinement, on the end-to-end test's scene
# ---------------------------------------------------------------------------


def _small_scene():
    sensor = small_refinement_sensor()
    fused = app_fusion.run(sensor, FusionConfig(voxel_size=SMALL_VOXEL, discont_window_size=0), device="cpu")
    return sensor, fused


def _jax_sensor(t: MemorySensor) -> JMemorySensor:
    n = t.num_frames
    return JMemorySensor(_jcam(t.color_cam), _jcam(t.depth_cam), [t.color(i) for i in range(n)],
                         [t.depth(i) for i in range(n)], [np.array(t.pose(i)) for i in range(n)],
                         t.depth_min, t.depth_max)


@pytest.fixture(scope="module")
def e2e():
    """The JAX refinement of the scene, with each level's `optimize_level`
    inputs and outputs recorded, and the port's refinement of the same
    fused grid."""
    sensor, fused = _small_scene()
    jcfg = JRefinementConfig(**dataclasses.asdict(SMALL_REFINEMENT))
    levels = []
    real = j_i3d.optimize_level

    def recording(grid, topo, params, cfg, cam, depths, images, voxel_sh, thres, rgbd, **kw):
        inputs = dict(grid=_tgrid(grid), params=params, depths=np.asarray(depths), images=np.asarray(images),
                      voxel_sh=np.array(voxel_sh), thres=thres, rgbd=rgbd, mu0=kw["mu0"], cg_iters=kw["cg_iters"])
        out = real(grid, topo, params, cfg, cam, depths, images, voxel_sh, thres, rgbd, **kw)
        levels.append((inputs, out))
        return out

    jinfos, tinfos = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_i3d, "optimize_level", recording)
        jeng = j_i3d.Intrinsic3D(jcfg, _jax_sensor(sensor), list(range(5)), cg_iters=SMALL_CG_ITERS)
        jeng.add_callback(lambda i: jinfos.append((i.grid_level, i.pyramid_level)))
        jref = jeng.refine(_jgrid(fused))
    teng = Intrinsic3D(SMALL_REFINEMENT, small_refinement_sensor(), list(range(5)), cg_iters=SMALL_CG_ITERS,
                       device="cpu")
    teng.add_callback(lambda i: tinfos.append((i.grid_level, i.pyramid_level, i.stats)))
    tref = teng.refine(fused)
    return dict(levels=levels, jinfos=jinfos, jref=jref, tinfos=tinfos, tref=tref, jsensor=jeng.sensor,
                tsensor=teng.sensor)


def test_optimize_level_matches_jax(e2e):
    """The coarsest level's outer iterations from the JAX level's recorded
    inputs: per-iteration costs, tries, μ and the final parameters."""
    inputs, (jparams, jmu, jst) = e2e["levels"][0]
    assert inputs["rgbd"] == 1
    p = Params(*(_t(np.asarray(f)) for f in inputs["params"]))
    cam = Camera.create(90.0, 90.0, 47.5, 35.5, 96, 72)
    params, mu, st = opt.optimize_level(
        inputs["grid"], None, p, SMALL_REFINEMENT, cam, _t(inputs["depths"]), _t(inputs["images"]),
        inputs["voxel_sh"], inputs["thres"], inputs["rgbd"], mu0=inputs["mu0"], cg_iters=inputs["cg_iters"],
        device="cpu",
    )
    assert st.tries == jst.tries
    assert st.reason == "dense (full frame coverage, fits HBM)"
    np.testing.assert_allclose(st.costs_before, jst.costs_before, rtol=1e-3)
    np.testing.assert_allclose(st.costs_after, jst.costs_after, rtol=1e-3)
    np.testing.assert_allclose(st.mus, jst.mus, rtol=1e-3)
    np.testing.assert_allclose(mu, jmu, rtol=1e-3)
    for name, got, want in zip(Params._fields, params, jparams):
        tol = 1e-3 if name == "albedo" else 1e-5
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, err_msg=name)


def test_refine_matches_jax(e2e):
    """The whole refinement: the same (grid, pyramid) schedule, per-level
    costs, voxel sets and final voxel size, and the refined fields on the
    common voxels."""
    jref, tref = e2e["jref"], e2e["tref"]
    assert [i[:2] for i in e2e["tinfos"]] == e2e["jinfos"] == [(1, 1), (1, 0), (0, 0)]
    for (_, (_, _, jst)), (_, _, tst) in zip(e2e["levels"], e2e["tinfos"]):
        assert tst.tries == jst.tries
        np.testing.assert_allclose(tst.costs_before, jst.costs_before, rtol=1e-3)
        np.testing.assert_allclose(tst.costs_after, jst.costs_after, rtol=1e-3)
    assert tref.voxel_size == jref.voxel_size == SMALL_VOXEL / 2
    assert tref.is_sbr
    common, ti, ji = np.intersect1d(tref.keys, jref.keys, return_indices=True)
    assert len(common) == tref.num_voxels == jref.num_voxels > 2000
    np.testing.assert_allclose(tref.sdf_refined[ti], jref.sdf_refined[ji], atol=1e-4)
    np.testing.assert_allclose(tref.albedo[ti], jref.albedo[ji], atol=1e-3)
    # colors: a voxel whose best observations tie or sit at the occlusion
    # gate may pick another frame (measured: 1 of 9,276 voxels, by 6.9)
    dcol = np.abs(tref.color[ti] - jref.color[ji]).max(axis=1)
    assert np.mean(dcol > 0.5) <= 0.005 and np.median(dcol) < 1e-2


def test_refined_poses_and_camera_match_jax(e2e):
    """The final keyframe poses and color camera both engines wrote back
    into their sensors. The scene's config fixes the poses (as the JAX
    end-to-end test does), so this pins the write-back chain: angle-axis →
    matrix → inverse, and the camera rebuilt from the refined intrinsics:
    atol 1e-6 (measured: equal to JAX's, and 1.1e-7 from the sensor's
    initial poses, float32 angle-axis round-trip). The refinement of free
    poses is held to JAX in tests/test_torch_apps.py and
    tests/test_torch_pose_refinement.py."""
    js, ts = e2e["jsensor"], e2e["tsensor"]
    for i in range(5):
        np.testing.assert_allclose(ts.pose(i), np.asarray(js.pose(i)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.pose(3), small_refinement_sensor().pose(3), rtol=0, atol=1e-6)
    jcam, tcam = js.color_cam, ts.color_cam
    np.testing.assert_array_equal(
        [tcam.fx, tcam.fy, tcam.cx, tcam.cy], [float(jcam.fx), float(jcam.fy), float(jcam.cx), float(jcam.cy)])
    np.testing.assert_array_equal(tcam.dist, np.asarray(jcam.dist))


def test_refinement_entry_points_default_to_the_card(problems, monkeypatch):
    """Called without `device=`, every new entry point asks for CUDA and
    raises when there is none — never a silent CPU fallback."""
    _, tp = problems
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = _noisy_level_grid(tp)
    with pytest.raises(RuntimeError, match="CUDA"):
        Intrinsic3D(SMALL_REFINEMENT, small_refinement_sensor(), [0, 1])
    with pytest.raises(RuntimeError, match="CUDA"):
        opt.optimize_level(tp.grid, tp.topo, tp.params, tp.cfg, tp.cam, tp.depths, tp.images, tp.voxel_sh,
                           tp.thres_shell, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        opt.eg_hbm_budget()
    with pytest.raises(RuntimeError, match="CUDA"):
        svsh.estimate_svsh(g, 0.07, 10.0, 0.03)
    with pytest.raises(RuntimeError, match="CUDA"):
        alg.clear_voxels_outside_thin_shell(g, 0.03)
