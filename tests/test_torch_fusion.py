"""The port's keyframe selection and TSDF fusion against the JAX package, on
the CPU.

Inputs are made with numpy from seeds and passed to both packages; Pallas
kernels run as the JAX package's own tests run them here (interpret mode).
Tolerances, each with its reason:
- exact: the orbit dataset (the same numpy code), erosion (comparisons
  only), the scene bounds (float64 numpy), the keyframe choice and the
  voxel sets (measured: no allocated voxel differs at these sizes);
- blur scores rtol 1e-5: sums over ~3,000 pixels in another order;
- vertex maps, normals, resized depth atol 1e-6 (values O(1) m, 1-ulp
  differences in the cross product and the norm);
- fused fields: sdf atol 1e-6 (values ≤ 0.13 m), weight rtol 1e-5 (≤ 18),
  color atol 1e-3 (0..255) — the per-frame matmul and reductions round in
  another order (measured ≤ 1.5e-8, 4.3e-6 and 4.6e-5);
- distance transform: sdf atol 1e-6, weight exact (as
  `tests/test_pallas_ops.py` holds the Pallas kernel to the table path);
- the masked sampler: values atol 5e-5 and gradients atol 5e-4 on active
  elements (the JAX kernel's bf16 hi/lo split errs by up to
  2⁻¹⁶·Σ|w|·max|image|, as `tests/test_pallas_ops.py` allows).
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from intrinsic3d_tpu.apps import app_fusion as j_app_fusion
from intrinsic3d_tpu.apps import app_keyframes as j_app_keyframes
from intrinsic3d_tpu.camera import Camera as JCamera
from intrinsic3d_tpu.config import FusionConfig as JFusionConfig
from intrinsic3d_tpu.config import KeyframesConfig as JKeyframesConfig
from intrinsic3d_tpu.grid import algorithms as j_alg
from intrinsic3d_tpu.grid.fusion import FusionVolume as JFusionVolume
from intrinsic3d_tpu.grid.fusion import compute_scene_voxel_bounds as j_bounds
from intrinsic3d_tpu.grid.voxel_grid import VoxelGrid as JVoxelGrid
from intrinsic3d_tpu.image import blur as j_blur
from intrinsic3d_tpu.image import processing as j_proc
from intrinsic3d_tpu.image.interp import bilinear as j_bilinear
from intrinsic3d_tpu.ops.pallas.bicubic import bicubic_sample as j_bicubic_sample
from intrinsic3d_tpu.ops.pallas.distance_transform import correct_sdf_dense as j_correct_sdf_dense

from intrinsic3d_torch.apps import app_fusion, app_keyframes
from intrinsic3d_torch.camera import Camera
from intrinsic3d_torch.config import KeyframesConfig
from intrinsic3d_torch.grid import algorithms as alg
from intrinsic3d_torch.grid.fusion import FusionVolume, compute_scene_voxel_bounds
from intrinsic3d_torch.grid.voxel_grid import VoxelGrid
from intrinsic3d_torch.image import blur, processing
from intrinsic3d_torch.image.interp import bilinear
from intrinsic3d_torch.io.memory_sensor import MemorySensor
from intrinsic3d_torch.keyframes import KeyframeSelection
from intrinsic3d_torch.ops import bicubic, build
from intrinsic3d_torch.ops import distance_transform as dt
from intrinsic3d_torch.ops.distance_transform import correct_sdf_dense, correct_sdf_dense_plain
from intrinsic3d_torch.synthetic import (
    DEFAULT_CENTER,
    build_orbit_dataset,
    look_at_pose,
    pipeline_configs,
    render_sphere_depth,
)

REPO = Path(__file__).resolve().parents[1]
ORBIT = dict(num_frames=6, width=64, height=48, center=DEFAULT_CENTER, radius=0.12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes: one intra-op
    thread per process keeps torch from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bench_pipeline():
    spec = importlib.util.spec_from_file_location("bench_pipeline", REPO / "bench_pipeline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def orbit():
    j = _bench_pipeline().build_dataset(
        ORBIT["num_frames"], ORBIT["width"], ORBIT["height"], ORBIT["center"], ORBIT["radius"]
    )
    return j, build_orbit_dataset(**ORBIT)


def _jcam(cam: Camera) -> JCamera:
    return JCamera.create(cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height)


def _depth_stack(sensor) -> np.ndarray:
    return np.stack([sensor.depth(i) for i in range(sensor.num_frames)]).astype(np.float32)


def test_orbit_dataset_matches_bench_pipeline(orbit):
    j, t = orbit
    assert t.num_frames == j.num_frames
    for i in range(j.num_frames):
        np.testing.assert_array_equal(t.color(i), j.color(i))
        np.testing.assert_array_equal(t.depth(i), j.depth(i))
        np.testing.assert_array_equal(t.pose(i), j.pose(i))
    for f in ("fx", "fy", "cx", "cy", "width", "height"):
        assert float(getattr(t.depth_cam, f)) == float(getattr(j.depth_cam, f))
    assert (t.depth_min, t.depth_max) == (j.depth_min, j.depth_max)


def test_blur_scores_and_keyframes_match_jax(orbit, tmp_path):
    j, t = orbit
    frames = np.stack([t.color(i) for i in range(t.num_frames)])
    want = np.asarray(j_blur.blur_scores_batch(jnp.asarray(frames)))
    got = blur.blur_scores_batch(torch.as_tensor(frames))
    assert got.device.type == "cpu"  # follows its input
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)

    sel_j = j_app_keyframes.run(j, JKeyframesConfig(window_size=2, filename=""))
    sel_t = app_keyframes.run(t, KeyframesConfig(window_size=2, filename=""), batch=4, device="cpu")
    assert sel_t.is_keyframe == sel_j.is_keyframe
    assert sel_t.count() == 3
    np.testing.assert_allclose(sel_t.frame_scores, sel_j.frame_scores, rtol=1e-5)
    path = tmp_path / "keyframes.txt"
    sel_t.save(str(path))
    back = KeyframeSelection.load(str(path))
    assert back.window_size == 2 and back.is_keyframe == sel_t.is_keyframe
    np.testing.assert_allclose(back.frame_scores, sel_t.frame_scores, atol=5e-7)


def test_image_processing_matches_jax(orbit):
    _, t = orbit
    cam, jcam = t.depth_cam, _jcam(t.depth_cam)
    depths = _depth_stack(t)
    depths[2, 20:24, 30:40] += 0.7  # a discontinuity for the erosion
    for k in (1, 2):
        want = np.stack([np.asarray(j_proc.erode_discontinuities(jnp.asarray(d), k)) for d in depths])
        np.testing.assert_array_equal(processing.erode_discontinuities(torch.as_tensor(depths), k).numpy(), want)
    td = torch.as_tensor(depths)
    for i in (0, 3):
        d = jnp.asarray(depths[i])
        np.testing.assert_allclose(
            processing.compute_vertex_map(cam, td)[i].numpy(), np.asarray(j_proc.compute_vertex_map(jcam, d)), atol=1e-6
        )
        np.testing.assert_allclose(
            processing.compute_normals(cam, td)[i].numpy(), np.asarray(j_proc.compute_normals(jcam, d)), atol=1e-6
        )
    big = Camera.create(cam.fx * 1.5, cam.fy * 1.5, 47.5, 35.5, 96, 72)
    want = np.asarray(j_proc.resize_depth(jcam, jnp.asarray(depths[1]), _jcam(big)))
    got = processing.resize_depth(cam, td, big)
    assert got.shape == (6, 72, 96)
    np.testing.assert_allclose(got[1].numpy(), want, atol=1e-6)
    assert processing.resize_depth(cam, td, cam) is td
    want = np.asarray(j_proc.threshold_depth(jnp.asarray(depths), 0.35, 0.5))
    np.testing.assert_array_equal(processing.threshold_depth(td, 0.35, 0.5).numpy(), want)


def test_bilinear_matches_jax():
    """Out-of-image taps get zero weight and the rest is renormalized, on a
    1-channel and a 3-channel image (atol 1e-6)."""
    rng = np.random.default_rng(9)
    x = rng.uniform(-1.5, 13.5, 400).astype(np.float32)
    y = rng.uniform(-1.5, 9.5, 400).astype(np.float32)
    for shape in ((9, 13), (9, 13, 3)):
        img = rng.uniform(0.0, 1.0, shape).astype(np.float32)
        want = np.asarray(j_bilinear(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))
        got = bilinear(torch.as_tensor(img), torch.as_tensor(x), torch.as_tensor(y))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_voxel_grid_helpers_match_jax():
    """`lookup`, `exists`, `world_to_voxel`, `to_sbr`, `clone` and
    `apply_refined_sdf` of the port's grid against the JAX package's."""
    jg, tg = _sparse_grid(6, jax_cls=True), _sparse_grid(6)
    q = np.random.default_rng(7).integers(-2, 16, size=(50, 4, 3))
    np.testing.assert_array_equal(tg.lookup(q), jg.lookup(q))
    np.testing.assert_array_equal(tg.exists(q), jg.exists(q))
    pts = np.random.default_rng(8).uniform(-0.05, 0.2, size=(300, 3))
    np.testing.assert_array_equal(tg.world_to_voxel(pts), jg.world_to_voxel(pts))
    assert not tg.is_sbr
    js, ts = jg.to_sbr(), tg.to_sbr()
    assert ts.is_sbr and ts.num_voxels == js.num_voxels
    for f in ("coords", "sdf", "weight", "albedo", "sdf_refined"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    ts.sdf_refined = ts.sdf_refined + 1.0
    js.sdf_refined = js.sdf_refined + 1.0
    np.testing.assert_array_equal(alg.apply_refined_sdf(ts.clone()).sdf, j_alg.apply_refined_sdf(js.clone()).sdf)


def test_scene_voxel_bounds_match_jax(orbit):
    _, t = orbit
    poses = [t.pose(i) for i in range(t.num_frames)]
    _, fcfg = pipeline_configs(radius=ORBIT["radius"])
    for clip in (None, fcfg.clip_bounds):
        want = j_bounds(_jcam(t.depth_cam), poses, 0.1, 2.0, 0.004, clip)
        got = compute_scene_voxel_bounds(t.depth_cam, poses, 0.1, 2.0, 0.004, clip)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_fusion_volume_matches_jax():
    """The sphere scene of `tests/test_grid.py::sphere_fusion` (64×48, four
    poses, voxel 1 cm): per-frame allocation and integration."""
    cam = Camera.create(60.0, 60.0, 31.5, 23.5, 64, 48)
    jcam = _jcam(cam)
    center, radius, vs = np.array([0.0, 0.0, 0.6]), 0.2, 0.01
    eyes = ([0.0, 0.0, 0.0], [0.55, 0.0, 0.55], [-0.5, 0.1, 0.5], [0.0, 0.5, 0.35])
    poses = [look_at_pose(e, center) for e in eyes]
    depths = [render_sphere_depth(cam, T, center, radius) for T in poses]
    vlo, vhi = compute_scene_voxel_bounds(cam, poses, 0.1, 2.0, vs)
    jv = JFusionVolume(jcam, jcam, vs, vlo, vhi, 0.1, 2.0)
    tv = FusionVolume(cam, cam, vs, vlo, vhi, 0.1, 2.0, device="cpu")
    for d, T in zip(depths, poses):
        jv.allocate(d, T)
        tv.allocate(d, T)
    jg, tg = jv.build_grid(), tv.build_grid()
    np.testing.assert_array_equal(tg.coords, jg.coords)  # measured: 0 of 40,124 voxels differ
    rng = np.random.default_rng(5)
    for d, T in zip(depths, poses):
        normals = np.asarray(j_proc.compute_normals(jcam, jnp.asarray(d)))
        color = rng.uniform(0.0, 1.0, (48, 64, 3)).astype(np.float32)
        jv.integrate(d, normals, color, T)
        tv.integrate(d, normals, color, T)
    jg, tg = jv.finalize(), tv.finalize()
    assert (tg.weight > 0).sum() > 1000
    np.testing.assert_allclose(tg.sdf, jg.sdf, atol=1e-6)
    np.testing.assert_allclose(tg.weight, jg.weight, rtol=1e-5)
    np.testing.assert_allclose(tg.color, jg.color, atol=1e-3)


def _random_field(shape, density=0.3, seed=0):
    rng = np.random.default_rng(seed)
    sdf = rng.normal(0.0, 0.05, shape).astype(np.float32)
    w = (rng.uniform(size=shape) < density).astype(np.float32) * rng.uniform(1.0, 5.0, shape).astype(np.float32)
    return sdf, w


@pytest.mark.parametrize("shape,iters", [((20, 20, 20), 10), ((8, 8, 140), 4)], ids=["cube", "slab"])
def test_correct_sdf_dense_plain_matches_pallas(shape, iters):
    """The cases of `tests/test_pallas_ops.py`; Z > 128 takes JAX's slab path."""
    sdf, w = _random_field(shape, density=0.3 if iters == 10 else 0.5, seed=0 if iters == 10 else 1)
    want_s, want_w = j_correct_sdf_dense(jnp.asarray(sdf), jnp.asarray(w), 0.01, tile=8, iters=iters, interpret=True)
    got_s, got_w = correct_sdf_dense_plain(torch.as_tensor(sdf), torch.as_tensor(w), 0.01, iters=iters)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-6)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    assert not np.array_equal(got_s.numpy(), sdf)  # the sweeps did work
    # the wrapper takes the plain version for CPU tensors and launches nothing
    build.reset_launches()
    s2, w2 = correct_sdf_dense(torch.as_tensor(sdf), torch.as_tensor(w), 0.01, iters=iters)
    assert torch.equal(s2, got_s) and torch.equal(w2, got_w)
    assert build.LAUNCHES["correct_sdf_dense"] == 0


def _interiors(shape, plan, k):
    """The interior box of every block of a launch of k sweeps, as the
    kernel's grid cuts the window: (x0, x1, y0, y1, z0, z1)."""
    x, y, z = shape
    tz = plan.tile_z(k)
    for i in range(0, x, plan.seg):
        for j in range(0, y, plan.tile_y):
            for m in range(0, z, tz):
                yield i, min(i + plan.seg, x), j, min(j + plan.tile_y, y), m, min(m + tz, z)


def _run_schedule(sdf, weight, voxel_size, plan):
    """The plan's tile schedule in plain PyTorch: per launch of k sweeps,
    each block's interior grown by a k-deep halo (cut at the window, whose
    outside is invalid), swept k times, its interior kept; launches chained."""
    steps = torch.as_tensor(dt.step_lengths(voxel_size))
    shape = sdf.shape
    for k in plan.sweeps:
        out_s, out_w = torch.empty_like(sdf), torch.empty_like(weight)
        for box in _interiors(shape, plan, k):
            lo = [max(box[2 * d] - k, 0) for d in range(3)]
            hi = [min(box[2 * d + 1] + k, shape[d]) for d in range(3)]
            s_t, w_t = sdf[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]], weight[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
            for _ in range(k):
                s_t, w_t = dt._sweep_plain(s_t, w_t, steps)
            keep = tuple(slice(box[2 * d] - lo[d], box[2 * d + 1] - lo[d]) for d in range(3))
            dst = tuple(slice(box[2 * d], box[2 * d + 1]) for d in range(3))
            out_s[dst], out_w[dst] = s_t[keep], w_t[keep]
        sdf, weight = out_s, out_w
    return sdf, weight


# a dim smaller than the tile, a dim smaller than the sweeps of a launch,
# Z = 1, dims that are no multiples of the tile, the fusion path's window
DT_SHAPES = [((9, 5, 12), 0.4), ((3, 18, 20), 0.4), ((12, 10, 1), 0.5), ((17, 19, 61), 0.3), ((73, 63, 73), 0.05)]


@pytest.mark.parametrize("iters", [1, 3, 7, 10, 11])
@pytest.mark.parametrize("shape,density", DT_SHAPES, ids=["x".join(map(str, s)) for s, _ in DT_SHAPES])
def test_sweep_plan_schedule_matches_plain(shape, density, iters):
    """The kernel's tile schedule (halo as deep as a launch's sweeps) gives
    the plain version's sdf and weight bit for bit."""
    sdf, w = (torch.as_tensor(a) for a in _random_field(shape, density=density, seed=5))
    plan = dt.sweep_plan(shape, iters)
    got_s, got_w = _run_schedule(sdf, w, 0.01, plan)
    want_s, want_w = correct_sdf_dense_plain(sdf, w, 0.01, iters)
    assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))
    assert torch.equal(got_w, want_w)
    assert not torch.equal(got_s, sdf)  # the sweeps did work


def test_sweep_plan_schedule_matches_pallas():
    shape, iters = (17, 19, 61), 7
    sdf, w = _random_field(shape, density=0.3, seed=6)
    want_s, want_w = j_correct_sdf_dense(jnp.asarray(sdf), jnp.asarray(w), 0.01, tile=8, iters=iters, interpret=True)
    got_s, got_w = _run_schedule(torch.as_tensor(sdf), torch.as_tensor(w), 0.01, dt.sweep_plan(shape, iters))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-6)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))


@pytest.mark.parametrize("shape", [(9, 5, 12), (3, 18, 20), (12, 10, 1), (73, 63, 73), (247, 127, 301),
                                   (411, 211, 501), (1, 1, 1)])
def test_sweep_plan_covers_every_voxel_once(shape):
    for iters in (1, 3, 7, 10, 11):
        plan = dt.sweep_plan(shape, iters)
        k_max = (dt.SMALL_PLAN if np.prod(shape) <= dt.LARGE_FROM_VOXELS else dt.LARGE_PLAN)[0]
        assert sum(plan.sweeps) == iters and len(plan.sweeps) == -(-iters // k_max)
        assert all(0 < k <= min(k_max, dt.MAX_SWEEPS) for k in plan.sweeps)
        assert plan.cols % 32 == 0
        for k in plan.sweeps:
            assert dt.smem_bytes(k, plan.tile_y, plan.cols) <= dt.SMEM_BYTES and plan.tile_z(k) >= 1
            assert plan.threads(k) <= dt.MAX_THREADS
            boxes = list(_interiors(shape, plan, k))
            # the blocks' interiors cut each axis into consecutive runs, and
            # are their product, so they partition the window
            for d in range(3):
                runs = sorted({(b[2 * d], b[2 * d + 1]) for b in boxes})
                assert runs[0][0] == 0 and runs[-1][1] == shape[d]
                assert all(r0[1] == r1[0] for r0, r1 in zip(runs, runs[1:]))
            if np.prod(shape) <= 10**6:
                count = np.zeros(shape, np.int32)
                for x0, x1, y0, y1, z0, z1 in boxes:
                    count[x0:x1, y0:y1, z0:z1] += 1
                assert (count == 1).all()
            assert int(np.prod(plan.grid(shape, k))) == len(boxes) == len(set(boxes))


def _sweeps_by_keys(sdf, weight, voxel_size, iters):
    """`iters` sweeps as the kernel computes them: invalid voxels as NaN and
    -0 as +0, each class's least |nb| of the voxel's sign as the least
    unsigned (sdf >= 0) or signed (sdf < 0) bit pattern, plus the class's
    step; the input kept where |sdf| did not fall, else (sdf, 1)."""
    d = dt.class_steps(voxel_size)
    cls = np.abs(dt.OFFSETS).sum(axis=1) - 1
    nan = torch.tensor(float("nan"))
    v0 = torch.where(weight > 0, sdf + 0.0, nan)
    v = v0
    x, y, z = sdf.shape
    for _ in range(iters):
        bits = F.pad(v[None], (1, 1, 1, 1, 1, 1), value=float("nan"))[0].view(torch.int32).to(torch.int64)
        kp = [torch.full(sdf.shape, 2**32 - 1, dtype=torch.int64) for _ in range(3)]
        kn = [torch.full(sdf.shape, 2**31 - 1, dtype=torch.int64) for _ in range(3)]
        for k, (dx, dy, dz) in enumerate(dt.OFFSETS + 1):
            b = bits[dx:dx + x, dy:dy + y, dz:dz + z]
            kp[cls[k]] = torch.minimum(kp[cls[k]], b & 0xFFFFFFFF)
            kn[cls[k]] = torch.minimum(kn[cls[k]], b)
        pos = v >= 0
        best = torch.full(sdf.shape, float("inf"))
        for c in range(3):
            as_float = lambda k: ((k + 2**31) % 2**32 - 2**31).to(torch.int32).view(torch.float32)  # noqa: E731
            ok = torch.where(pos, kp[c] <= 0x7F800000, kn[c] <= -8388608)
            u = torch.where(pos, as_float(kp[c]), -as_float(kn[c]))
            best = torch.where(ok, torch.minimum(best, u + float(d[c])), best)
        v = torch.where(best < v.abs(), torch.where(pos, best, -best), v)
    fell = v.abs() < v0.abs()
    return torch.where(fell, v, sdf), torch.where(fell, torch.ones_like(weight), weight)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_candidate_rule_matches_plain(seed):
    """The kernel's arithmetic (class minima of integer keys, NaN for
    invalid voxels, -0 as +0, the output kept where |sdf| did not fall)
    gives the plain version's sdf and weight bit for bit, on fields with
    -0, +0, NaN and infinite values."""
    shape = (9, 11, 13)
    sdf, w = (torch.as_tensor(a) for a in _random_field(shape, density=0.6, seed=seed))
    rng = np.random.default_rng(seed)
    for value in (-0.0, 0.0, float("nan"), float("inf"), float("-inf")):
        sdf.view(-1)[torch.as_tensor(rng.integers(0, sdf.numel(), 6))] = value
    got_s, got_w = _sweeps_by_keys(sdf, w, 0.01, 4)
    want_s, want_w = correct_sdf_dense_plain(sdf, w, 0.01, 4)
    assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))
    assert torch.equal(got_w, want_w)
    assert not torch.equal(got_w, w)  # the sweeps did work


def _sparse_grid(seed, jax_cls=False):
    rng = np.random.default_rng(seed)
    cc = np.unique(rng.integers(0, 14, size=(600, 3)), axis=0)
    g = (JVoxelGrid if jax_cls else VoxelGrid).from_coords(0.01, cc)
    g.sdf = rng.normal(0, 0.05, g.num_voxels).astype(np.float32)
    g.weight = (rng.uniform(size=g.num_voxels) < 0.7).astype(np.float32)
    return g


def test_correct_sdf_routes_match_jax():
    """The table route against `_correct_sdf_device`, and the dense route on
    a sparse grid against `_correct_sdf_via_dense(interpret=True)`."""
    for dense in (False, True):
        jg, tg = _sparse_grid(2, jax_cls=True), _sparse_grid(2)
        if dense:
            j_alg._correct_sdf_via_dense(jg, num_iter=6, interpret=True)
        else:
            j_alg.correct_sdf(jg, num_iter=6, dense=False)
        alg.correct_sdf(tg, num_iter=6, dense=dense, device="cpu")
        np.testing.assert_allclose(tg.sdf, jg.sdf, atol=1e-6)
        np.testing.assert_array_equal(tg.weight, jg.weight)
    # the CPU picks the table route by itself
    g = _sparse_grid(3)
    want = alg.correct_sdf(g.clone(), num_iter=6, dense=False, device="cpu")
    got = alg.correct_sdf(g, num_iter=6, device="cpu")
    np.testing.assert_array_equal(got.sdf, want.sdf)
    kept = alg.clear_invalid_voxels(got)
    assert kept.num_voxels == int((got.weight > 0).sum()) and np.all(kept.weight > 0)


def _sampler_problem(m=1500, k=3, h=24, w=40, seed=3):
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 1, (k, h, w)).astype(np.float32)
    fid = rng.integers(0, k, m).astype(np.int32)
    x = rng.uniform(1.0, w - 2.01, m).astype(np.float32)
    y = rng.uniform(1.0, h - 2.01, m).astype(np.float32)
    active = (rng.uniform(size=m) < 0.3).astype(np.float32)
    return images, fid, x, y, active


def test_bicubic_sample_matches_jax():
    """K4a/K4b: the port's value and its gradient of Σ sin(sample) in x and
    y against the JAX `bicubic_sample` (Pallas, interpret mode), on active
    elements; inactive elements give 0 and a zero gradient in the port."""
    images, fid, x, y, active = _sampler_problem()
    act = active > 0

    def f_jax(x_, y_):
        return jnp.sum(jnp.sin(j_bicubic_sample(jnp.asarray(images), jnp.asarray(fid), x_, y_, jnp.asarray(active))))

    want = np.asarray(j_bicubic_sample(*(jnp.asarray(a) for a in (images, fid, x, y, active))))
    wgx, wgy = jax.grad(f_jax, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))

    xt = torch.as_tensor(x).requires_grad_(True)
    yt = torch.as_tensor(y).requires_grad_(True)
    build.reset_launches()
    out = bicubic.bicubic_sample(torch.as_tensor(images), torch.as_tensor(fid), xt, yt, torch.as_tensor(active))
    gx, gy = torch.autograd.grad(torch.sin(out).sum(), (xt, yt))
    assert build.LAUNCHES["bicubic_sample_fwd"] == 0 and build.LAUNCHES["bicubic_sample_bwd"] == 0
    np.testing.assert_allclose(out.detach().numpy()[act], want[act], atol=5e-5)
    np.testing.assert_allclose(gx.numpy()[act], np.asarray(wgx)[act], atol=5e-4)
    np.testing.assert_allclose(gy.numpy()[act], np.asarray(wgy)[act], atol=5e-4)
    assert not out.detach().numpy()[~act].any()
    assert not gx.numpy()[~act].any() and not gy.numpy()[~act].any()
    # the analytic derivatives of the kernel's plain twin agree with autograd
    _, ddx, ddy = bicubic.bicubic_rows_plain(*(torch.as_tensor(a) for a in (images, fid, x, y, active)))
    cos = torch.cos(out.detach())
    torch.testing.assert_close(gx, cos * ddx, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gy, cos * ddy, rtol=1e-5, atol=1e-5)


def _slice_sensor(pkg_sensor_cls, cam_cls, orbit_sensor):
    """A MemorySensor of either package over the orbit frames."""
    s = orbit_sensor
    cam = cam_cls.create(s.depth_cam.fx, s.depth_cam.fy, s.depth_cam.cx, s.depth_cam.cy,
                         s.depth_cam.width, s.depth_cam.height)
    return pkg_sensor_cls(
        cam, cam, [s.color(i) for i in range(s.num_frames)], list(s._depths),
        [s.pose(i) for i in range(s.num_frames)], depth_min=s.depth_min, depth_max=s.depth_max,
    )


def test_keyframes_and_fusion_slice_match_jax(orbit, tmp_path):
    """The slice as a whole: `app_keyframes.run` then `app_fusion.run` over
    the selected keyframes, with clip bounds and keyframe window 2, in both
    packages — the same keyframes, the same voxel set, fields within the
    module tolerances."""
    from intrinsic3d_tpu.io.memory_sensor import MemorySensor as JMemorySensor

    _, t = orbit
    js = _slice_sensor(JMemorySensor, JCamera, t)
    ts = _slice_sensor(MemorySensor, Camera, t)
    kcfg, fcfg = pipeline_configs(radius=ORBIT["radius"], window_size=2)
    sel_j = j_app_keyframes.run(js, JKeyframesConfig(window_size=2, filename=""))
    sel_t = app_keyframes.run(ts, kcfg, device="cpu")
    assert sel_t.is_keyframe == sel_j.is_keyframe
    path = str(tmp_path / "keyframes.txt")
    sel_t.save(path)
    fcfg.keyframes = path
    jcfg = JFusionConfig(**{f: getattr(fcfg, f) for f in fcfg.__dataclass_fields__})
    jg = j_app_fusion.run(js, jcfg)
    stats = {}
    tg = app_fusion.run(ts, fcfg, device="cpu", stats=stats)
    assert set(app_fusion.PHASES) <= set(stats) and stats["kept"] == tg.num_voxels
    assert tg.num_voxels > 500
    np.testing.assert_array_equal(tg.coords, jg.coords)
    np.testing.assert_allclose(tg.sdf, jg.sdf, atol=1e-6)
    np.testing.assert_allclose(tg.weight, jg.weight, rtol=1e-5)
    np.testing.assert_allclose(tg.color, jg.color, atol=1e-3)


def test_fusion_entry_points_default_to_the_card(orbit, monkeypatch):
    """Called without `device=`, each entry point asks for CUDA and raises
    when there is none — never a silent CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, t = orbit
    kcfg, fcfg = pipeline_configs(radius=ORBIT["radius"])
    cam = t.depth_cam
    with pytest.raises(RuntimeError, match="CUDA"):
        app_keyframes.run(t, kcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        app_fusion.run(t, fcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        FusionVolume(cam, cam, 0.004, np.zeros(3), np.full(3, 4), 0.1, 2.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        alg.correct_sdf(_sparse_grid(4))


def test_port_imports_no_jax():
    """Every module of `intrinsic3d_torch`, and `chip_smoke.py`, imported in
    a fresh interpreter, load no module of JAX or of the JAX package; nor do
    the three apps' `main`s (resolved, not run) and a call into the native
    host library (built on first use)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')], 'jax preloaded'\n"
        "import intrinsic3d_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(intrinsic3d_torch.__path__, 'intrinsic3d_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "new = ['native', 'visualization', 'io.dataset', 'io.golden_dataset', 'io.ply', 'io.trajectory',\n"
        "       'io.tsdf_io', 'mesh.extract', 'mesh.marching_cubes', 'mesh.metrics', 'mesh.util',\n"
        "       'apps.common', 'apps.app_intrinsic3d', 'timer', 'bench', 'bench_pipeline']\n"
        "missing = [n for n in new if 'intrinsic3d_torch.' + n not in names]\n"
        "assert not missing, missing\n"
        "from intrinsic3d_torch.apps import app_fusion, app_intrinsic3d, app_keyframes\n"
        "assert all(callable(m.main) for m in (app_fusion, app_intrinsic3d, app_keyframes))\n"
        "import numpy as np\n"
        "from intrinsic3d_torch import native\n"
        "assert native.find_indices(np.zeros((2, 3), np.int32) + [[0, 0, 0], [1, 2, 3]], [[1, 2, 3]])[0] == 1\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'intrinsic3d_tpu'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 25, res.stdout
