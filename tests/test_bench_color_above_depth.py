"""The benchmark's colour-above-depth cell (`benchmark/traffic/color-above-depth.py`,
`benchmark/reference/reproject.py`, `benchmark/reference/fusion_two_cameras.py`)
on the CPU at a tiny size: `benchmark/tests/conftest.py`'s tiny
configuration with its depth capture at 64x48 under colour frames at
128x96.

A sound run is correct, and the planners' depth pixels it counted level by
level are the level shapes'; the bfloat16 control is not correct; three planted
faults are each caught: the port's reprojection with a nearest lookup in
place of the bilinear one, fusion reading colour through the depth camera,
and a recorded level depth shifted by half a pixel. All are planted in the
sound run's kept job, so one run is paid. Unit cases hold the port's
`resize_depth`, its two-camera `FusionVolume` and the engine's span and
counter to the reference at small sizes; the planners' strided mips are held
bitwise to the reduction they replaced. ~50–65 s on one worker.
"""

import copy
import importlib.util
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import check, harness, run, scene
from benchmark.reference import fusion, fusion_two_cameras, reproject
from benchmark.tests.conftest import REPO, TINY_LIMITS, make_root, tiny_config

from torch_support import one_torch_thread  # noqa: F401

SEED = 2**31 + 211
CELL = "tinycolor.color-above-depth"
# the tiny cell's limits: `benchmark/tests/conftest.py`'s, and the
# reprojection's gap (a sound run 1.4e-7, the bfloat16 control 8.2e-3)
LIMITS = dict(TINY_LIMITS, reproject_gap=1e-4)
NEW_METRICS = ("levels.reproject_ms", "plan.depth_mpx")


def _config() -> dict:
    cfg = tiny_config()
    cfg["name"] = "tinycolor"
    cfg["scene"].update(width=64, height=48)
    cfg["color"] = dict(width=128, height=96)
    cfg["limits"] = dict(LIMITS)
    return cfg


def _traffic():
    """The job kind's module, for its helpers."""
    spec = importlib.util.spec_from_file_location("color_above_depth", REPO / "benchmark/traffic/color-above-depth.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny benchmark with a colour-above-depth cell."""
    path = make_root(tmp_path_factory.mktemp("color"))
    (path / "benchmark/configs/tinycolor.json").write_text(json.dumps(_config()))
    b = json.loads((path / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="tinycolor", file="benchmark/configs/tinycolor.json"))
    b["workloads"].append(dict(name=CELL, config="tinycolor", traffic="color-above-depth", chips=1, why="tests"))
    for m in b["per_layer"]:
        if m["name"] in NEW_METRICS:
            m["workloads"].append(CELL)
    (path / "BENCHMARK.json").write_text(json.dumps(b))
    return path


@pytest.fixture(scope="module")
def sound(root):
    """The sound run: its result and the (job, frames, cell) the check
    read."""
    kept = []
    load = harness.load_cell

    def load_cell(name, root=harness.ROOT):
        cell = load(name, root)
        readings = cell.kind.readings

        def keeping(job, frames, cell, **kw):
            kept.append((job, frames, cell))
            return readings(job, frames, cell, **kw)

        cell.kind.readings = keeping
        return cell

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "load_cell", load_cell)
        res = run.execute(CELL, SEED, 0.0, False, device="cpu", root=root)
    return res, kept


def _failed(readings: dict) -> set:
    return {k for k, (_, _, ok) in check.judge(readings, LIMITS).items() if not ok}


def test_sound_run_is_correct_at_the_colour_resolution(sound):
    res, kept = sound
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert set(res["checks"]) == set(check.NUMBERS) | {"reproject_gap"}
    job, frames, cell = kept[0]
    # the sensor read colour at 128x96 and depth at 64x48; every pyramid-0
    # level solved on depth reprojected to the colour camera
    assert frames.colors.shape[1:3] == (96, 128) and frames.depths.shape[1:] == (48, 64)
    assert [(int(lv["rgbd"]), tuple(lv["depths"].shape[1:])) for lv in job.levels] == [
        (1, (48, 64)), (0, (96, 128)), (0, (96, 128))]


def test_the_planners_depth_pixels_are_the_level_shapes(sound, root):
    job = sound[1][0][0]
    k = len(job.kf_ids)
    # a plan a level, each reading its level's depth maps once: g1p1 at
    # 64x48, g1p0 and g0p0 at 128x96
    assert [lv["stats"].plan_depth_px for lv in job.levels] == [k * 64 * 48, k * 128 * 96, k * 128 * 96]
    read = harness.load_metric("plan.depth_mpx", root).read
    assert read(SimpleNamespace(jobs=[job])) == k * (64 * 48 + 2 * 128 * 96) / 1e6


def test_the_bfloat16_control_is_not_correct(sound):
    job, frames, cell = sound[1][0]
    failed = _failed(cell.kind.readings(job, frames, cell, control=True))
    assert failed >= {"kf_score_gap", "fusion_gap", "fusion_voxel_mismatch", "svsh_gap", "cost_start_gap",
                      "cost_end_gap", "recolor_gap", "transition_gap", "reproject_gap"}, failed
    assert "refine_gain" not in failed


def _nearest_lookup(job, frames, cell):
    """The port's reprojection with a nearest lookup in place of the
    bilinear one, as every pyramid-0 level would have received it."""
    from intrinsic3d_torch.camera import Camera
    from intrinsic3d_torch.image import processing

    def nearest(img, x, y):
        h, w = img.shape[0], img.shape[1]
        return img[torch.floor(y + 0.5).long().clamp(0, h - 1), torch.floor(x + 0.5).long().clamp(0, w - 1)]

    cams = [Camera.create(d["fx"], d["fy"], d["cx"], d["cy"], d["width"], d["height"])
            for d in (frames.cam, _traffic().color_cam(cell.config))]
    depths = frames.depths[torch.as_tensor(job.kf_ids)].float()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(processing, "bilinear", nearest)
        bad = processing.resize_depth(cams[0], depths, cams[1])
    for lv in job.levels:
        if int(lv["rgbd"]) == 0:
            lv["depths"] = bad


def _colour_through_depth_camera(job, frames, cell):
    """The port's fusion with colour looked up through the depth camera."""
    from intrinsic3d_torch.apps import app_fusion
    from intrinsic3d_torch.camera import Camera
    from intrinsic3d_torch.io.memory_sensor import MemorySensor

    d = frames.cam
    cam = Camera.create(d["fx"], d["fy"], d["cx"], d["cy"], d["width"], d["height"])
    sensor = MemorySensor(cam, cam, list(frames.colors.numpy()), list(frames.depths.numpy()),
                          list(frames.poses.numpy()), depth_min=float(cell.config["sensor"]["min_depth"]),
                          depth_max=float(cell.config["sensor"]["max_depth"]))
    job.fused = harness.grid_fields(app_fusion.run(sensor, cell.settings[1], device="cpu"))


def _level_depth_shifted(job, frames, cell):
    """The last level's depth maps sampled half a pixel to the left."""
    d = job.levels[-1]["depths"]
    job.levels[-1]["depths"] = 0.5 * (d + torch.roll(d, 1, dims=-1))


@pytest.mark.parametrize("fault,caught_by", [
    (_nearest_lookup, "reproject_gap"),
    (_colour_through_depth_camera, "fusion_gap"),
    (_level_depth_shifted, "reproject_gap"),
], ids=["nearest_lookup", "colour_through_depth_camera", "level_depth_shifted"])
def test_a_planted_fault_is_caught(sound, fault, caught_by):
    job, frames, cell = sound[1][0]
    bad = copy.copy(job)
    bad.levels = [dict(lv) for lv in job.levels]
    fault(bad, frames, cell)
    r = cell.kind.readings(bad, frames, cell)
    assert caught_by in _failed(r), r


def _mips_by_reshape(depth):
    """The planner's depth-interval mips as the port first pooled them: a
    reduction over 2-wide axes of the padded map, the reference the strided
    pooling is held to."""
    valid = depth > 0.0
    dmin = np.where(valid, depth, np.inf).astype(np.float64)
    dmax = np.where(valid, depth, -np.inf).astype(np.float64)
    mips = [(dmin, dmax)]
    while max(dmin.shape) > 1:
        h, w = dmin.shape
        ph, pw = (h + 1) // 2 * 2, (w + 1) // 2 * 2

        def pool(a, f, fill):
            p = np.full((ph, pw), fill, a.dtype)
            p[:h, :w] = a
            return f(f(p.reshape(ph // 2, 2, pw // 2, 2), axis=3), axis=1)

        dmin, dmax = pool(dmin, np.min, np.inf), pool(dmax, np.max, -np.inf)
        mips.append((dmin, dmax))
    return mips


@pytest.mark.parametrize("shape", [(96, 128), (97, 129), (30, 1), (1, 7)], ids=["even", "odd", "column", "row"])
def test_planner_mips_are_bitwise_the_reshape_pooling(shape):
    """The planners' min/max mips (`blockform._depth_interval_mips`, 4.5x
    faster at 1296x968 since colour-resolution levels made them the p0
    joins' wait) are bitwise the 2-wide-axis reduction's, level by level,
    zeros (no depth) included."""
    from intrinsic3d_torch.refine import blockform

    rng = np.random.default_rng(7)
    depth = np.where(rng.random(shape) < 0.3, 0.0, rng.uniform(0.2, 1.5, shape)).astype(np.float32)
    got, want = blockform._depth_interval_mips(depth), _mips_by_reshape(depth)
    assert len(got) == len(want)
    for (gmin, gmax), (wmin, wmax) in zip(got, want):
        assert gmin.dtype == wmin.dtype == np.float64 and gmin.shape == wmin.shape
        assert np.array_equal(gmin, wmin) and np.array_equal(gmax, wmax)


def test_reprojected_depth_is_contiguous_for_the_card_samplers():
    """The card's samplers take only contiguous `[K, H, W]` stacks
    (`ops.bicubic._check`): the reprojection and the engine's depth
    pyramid built on it are contiguous, for a stack and for one frame."""
    from intrinsic3d_torch.camera import Camera
    from intrinsic3d_torch.image.processing import resize_depth
    from intrinsic3d_torch.image.pyramid import depth_down

    small = Camera.create(50.0, 50.0, 15.5, 11.5, 32, 24)
    big = Camera.create(100.0, 100.0, 31.5, 23.5, 64, 48)
    d = torch.rand(3, 24, 32)
    stack = resize_depth(small, d, big)
    assert stack.shape == (3, 48, 64) and stack.is_contiguous() and depth_down(stack).is_contiguous()
    assert resize_depth(small, d[1], big).is_contiguous()
    assert torch.equal(resize_depth(small, d[1], big), stack[1])


def _cam(fx, cx, cy, w, h) -> dict:
    return dict(fx=scene.f32(fx), fy=scene.f32(fx), cx=scene.f32(cx), cy=scene.f32(cy), width=w, height=h)


@pytest.mark.parametrize("colour", [
    _cam(0.92 * 100, 49.5, 37.0, 100, 75),  # the focal rule at 2.5x the pixels: the same field of view
    _cam(0.5 * 90, 44.5, 33.5, 90, 68),  # a wider view: its border reads outside the depth image
], ids=["same_view", "wider_view"])
def test_port_resize_depth_is_the_reference(colour):
    """The port's float32 reprojection against the float64 reference on
    the orbit's depth maps, silhouettes included: the same valid pixels and
    the same depths to 2e-6 m (5.9e-7 and 5.4e-7 m read): the float32
    pixel coordinates and weights round about 1e-6 of a pixel apart from
    the float64 ones, and across a silhouette's 0.4 m step that moves a
    blended depth by up to ~5e-7 m."""
    from intrinsic3d_torch.camera import Camera
    from intrinsic3d_torch.image.processing import resize_depth

    sc = dict(tiny_config()["scene"], width=40, height=30)
    cap = scene.render_orbit(sc, SEED, "cpu")
    depth = _cam(cap.fx, cap.cx, cap.cy, 40, 30)
    ref = reproject.resize_depth(cap.depths, depth, colour)
    cams = [Camera.create(d["fx"], d["fy"], d["cx"], d["cy"], d["width"], d["height"]) for d in (depth, colour)]
    got = resize_depth(cams[0], cap.depths, cams[1]).double()
    assert got.shape == ref.shape == (cap.depths.shape[0], colour["height"], colour["width"])
    assert torch.equal(got > 0, ref > 0)
    assert float(torch.max(torch.abs(got - ref))) < 2e-6
    if colour["fx"] < 50:
        assert not bool((ref[:, :, 0] > 0).any())  # outside the depth image: 0
    # the gap reads 0 on itself and 1 where the other map has nothing
    assert reproject.reproject_gap(ref, ref) == 0.0
    assert reproject.reproject_gap(torch.zeros_like(ref), ref) == 1.0


def test_port_fusion_through_two_cameras_is_the_reference():
    """The port's `FusionVolume` fed colour at 100x75 over depth at 40x30
    against `fusion_two_cameras.fuse`: the same voxels, and the p99 gap
    (|Δsdf| / voxel, |Δweight| / weight, |Δcolour| / 255) at float32's
    rounding, under 1e-4 (the sound tiny run reads 6e-6)."""
    from intrinsic3d_torch.apps import app_fusion
    from intrinsic3d_torch.camera import Camera
    from intrinsic3d_torch.io.memory_sensor import MemorySensor

    cfg = tiny_config()
    sc = dict(cfg["scene"], width=40, height=30, frames=6)
    dcap = scene.render_orbit(sc, SEED, "cpu")
    ccap = scene.render_orbit(dict(sc, width=100, height=75), SEED, "cpu")
    assert torch.equal(dcap.poses, ccap.poses)
    dc, cc = (_cam(c.fx, c.cx, c.cy, c.width, c.height) for c in (dcap, ccap))
    cams = [Camera.create(d["fx"], d["fy"], d["cx"], d["cy"], d["width"], d["height"]) for d in (cc, dc)]
    lo, hi = float(cfg["sensor"]["min_depth"]), float(cfg["sensor"]["max_depth"])
    sensor = MemorySensor(cams[0], cams[1], list(ccap.colors.numpy()), list(dcap.depths.numpy()),
                          list(dcap.poses.numpy()), depth_min=lo, depth_max=hi)
    fu_cfg = harness.settings(cfg)[1]
    port = harness.grid_fields(app_fusion.run(sensor, fu_cfg, device="cpu"))
    d = torch.where((dcap.depths < lo) | (dcap.depths > hi), torch.zeros_like(dcap.depths), dcap.depths)
    ref = fusion_two_cameras.fuse(d, ccap.colors, dcap.poses, dc, cc, cfg["fusion"], lo, hi)
    r = fusion.compare_fused(port, ref, float(cfg["fusion"]["voxel_size"]))
    assert r["fusion_voxel_mismatch"] == 0.0 and r["fusion_gap"] < 1e-4, r
    # through one camera the colours differ
    one = fusion.fuse(d, ccap.colors, dcap.poses, dc, cfg["fusion"], lo, hi)
    assert fusion.compare_fused(port, one, float(cfg["fusion"]["voxel_size"]))["fusion_gap"] > 1e-2


def test_color_capture_keeps_the_poses_and_hands_over_the_colour_camera():
    """The job kind's colour frames: the depth capture's poses bitwise, the
    colour camera in the sensor and in the capture's `init`, once."""
    cfg = _config()
    cell = SimpleNamespace(config=cfg)
    cap = harness.prepare(SimpleNamespace(config=cfg), SEED, torch.device("cpu"))
    depth_cam = cap.sensor.depth_cam
    mod = _traffic()
    mod.color_capture(cell, cap, torch.device("cpu"))
    assert np.asarray(cap.sensor.color(0)).shape == (96, 128, 3)
    assert cap.sensor.depth(0).shape == (48, 64) and cap.sensor.depth_cam is depth_cam
    assert cap.init[1] is cap.sensor.color_cam and cap.sensor.color_cam.width == 128
    assert float(cap.sensor.color_cam.fx) == scene.f32(0.92 * 128)
    first = cap.sensor
    mod.color_capture(cell, cap, torch.device("cpu"))
    assert cap.sensor is first
    # the colour frames' start view is the depth capture's
    view = scene.start_view(SEED, int(cfg["scene"]["frames"]), int(cfg["scene"]["blur_every"]))
    assert mod.start_view(cfg, cap.frames["poses"][0]) == view


def test_reproject_reader_on_hand_made_events():
    """`levels.reproject_ms` takes, for each `pyramids.reproject` range, the
    device operations that start first once it opens, as many as the host
    queued inside it."""
    host = [(0.0, 10.0, "job"), (1.0, 1.2, "pyramids.reproject"), (1.01, 1.02, "cudaLaunchKernel"),
            (1.05, 1.06, "cudaLaunchKernel"), (1.1, 1.11, "cudaMemsetAsync"), (1.3, 1.31, "cudaLaunchKernel"),
            (10.0, 20.0, "job"), (11.0, 11.1, "pyramids.reproject"), (11.01, 11.02, "cudaLaunchKernel")]
    device = [(0.5, 0.9, "upload"), (1.03, 1.5, "k1"), (1.5, 1.7, "k2"), (1.7, 1.75, "Memset"),
              (1.8, 1.9, "after"), (11.05, 11.25, "k3"), (11.3, 11.4, "after")]
    read = harness.load_metric("levels.reproject_ms").read
    ctx = SimpleNamespace(host=host, device=device, jobs=[1, 2])
    assert read(ctx) == pytest.approx((0.47 + 0.2 + 0.05 + 0.2) * 1e3 / 2)
    assert read(SimpleNamespace(host=host[:1], device=device, jobs=[1])) is None
    assert read(SimpleNamespace(host=host, device=[], jobs=[1])) is None


def test_plan_reader_on_hand_made_levels():
    def job(*px):
        return SimpleNamespace(levels=[dict(stats=SimpleNamespace(plan_depth_px=p)) for p in px])

    read = harness.load_metric("plan.depth_mpx").read
    assert read(SimpleNamespace(jobs=[job(1_000_000, 3_000_000), job(2_000_000)])) == 3.0
    # a program without the count, and a job without levels: nothing to read
    assert read(SimpleNamespace(jobs=[SimpleNamespace(levels=[dict(stats=SimpleNamespace())])])) is None
    assert read(SimpleNamespace(jobs=[SimpleNamespace(levels=[])])) is None


def test_engine_opens_the_reproject_span_only_where_the_cameras_differ():
    """`Intrinsic3D` reprojects depth under `pyramids.reproject` where the
    colour camera's size differs from the depth camera's, and opens no such
    span where they are one size; the planners' count is per thread."""
    from torch.profiler import ProfilerActivity, profile

    from intrinsic3d_torch.camera import Camera
    from intrinsic3d_torch.io.memory_sensor import MemorySensor
    from intrinsic3d_torch.refine import blockform
    from intrinsic3d_torch.refine.intrinsic3d import Intrinsic3D

    cfg = tiny_config()
    rf = harness.settings(cfg)[2]
    sc = dict(cfg["scene"], width=40, height=30, frames=3)
    dcap = scene.render_orbit(sc, SEED, "cpu")
    ccap = scene.render_orbit(dict(sc, width=80, height=60), SEED, "cpu")
    dcam = Camera.create(dcap.fx, dcap.fy, dcap.cx, dcap.cy, 40, 30)
    ccam = Camera.create(ccap.fx, ccap.fy, ccap.cx, ccap.cy, 80, 60)
    names = []
    for cam, cap in ((ccam, ccap), (dcam, dcap)):
        sensor = MemorySensor(cam, dcam, list(cap.colors.numpy()), list(dcap.depths.numpy()),
                              list(dcap.poses.numpy()))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            engine = Intrinsic3D(rf, sensor, [0, 1, 2], device="cpu")
        names.append([e.name for e in prof.events() if e.name.startswith("pyramids")])
        assert tuple(engine.depths_lvl[0].shape) == (3, cam.height, cam.width)
        assert all(d.is_contiguous() for d in engine.depths_lvl)
    assert names[0].count("pyramids.reproject") == 1 and "pyramids.reproject" not in names[1]

    n0 = blockform.depth_pixels_scanned()
    blockform._depth_interval_mips(np.ones((30, 40)))
    assert blockform.depth_pixels_scanned() == n0 + 1200
