"""The refinement's level pipeline: the host preparation threads of the
port (`refine.optimizer.LevelPrep`, `grid.algorithms.UpsamplePrep`) against
the serial builds and the JAX package, on the CPU.

Everything here is compared bitwise: the preps run the same host numpy code
as the serial path on the same inputs, and the JAX package's counterparts
are numpy too (`build_level_static(device=False)`, `plan_eg_layout`,
`UpsamplePrep(warm_program=False)`, the host sparsify), so no XLA program is
compiled. The threads must touch nothing of torch (no CUDA call, no
collective, no tensor), hand their exception to the joining thread, and
never outlive `Intrinsic3D.refine`.
"""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

from intrinsic3d_tpu.config import RefinementConfig as JRefinementConfig
from intrinsic3d_tpu.grid import algorithms as j_alg
from intrinsic3d_tpu.grid.blocks import BlockLayout as JBlockLayout
from intrinsic3d_tpu.grid.voxel_grid import VoxelGrid as JVoxelGrid
from intrinsic3d_tpu.refine.assembly import LevelTopology as JLevelTopology
from intrinsic3d_tpu.refine.device_assembly import build_level_static as j_build_level_static
from intrinsic3d_tpu.refine.optimizer import plan_eg_layout as j_plan_eg_layout

from intrinsic3d_torch.apps import app_fusion
from intrinsic3d_torch.config import FusionConfig, RefinementConfig
from intrinsic3d_torch.grid import algorithms as alg
from intrinsic3d_torch.grid.blocks import BlockLayout
from intrinsic3d_torch.grid.voxel_grid import VoxelGrid
from intrinsic3d_torch.ops import build
from intrinsic3d_torch.ops import upsample as up_ops
from intrinsic3d_torch.prefetch import HostPrep
from intrinsic3d_torch.refine import optimizer as opt
from intrinsic3d_torch.refine.assembly import LevelTopology
from intrinsic3d_torch.refine.device_assembly import fill_voxel_sh, level_static_host
from intrinsic3d_torch.refine.intrinsic3d import Intrinsic3D
from intrinsic3d_torch.synthetic import (
    SMALL_CG_ITERS,
    SMALL_REFINEMENT,
    SMALL_VOXEL,
    build_sphere_problem,
    small_refinement_sensor,
)

FIELDS = ("coords", "keys", "sdf", "weight", "color", "albedo", "sdf_refined")
# a level with frame buckets (forced), planned with room to spare: the JAX
# planner's dense constant then decides nothing, so both plans agree
BUDGET = 1e12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test files run in parallel worker processes: one intra-op thread per
    process keeps torch from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prep_threads():
    return [t for t in threading.enumerate() if t.name.startswith(HostPrep.THREAD_PREFIX) and t.is_alive()]


def _jgrid(g: VoxelGrid) -> JVoxelGrid:
    c = lambda a: None if a is None else np.array(a)  # noqa: E731
    return JVoxelGrid(
        voxel_size=g.voxel_size, coords=c(g.coords), keys=c(g.keys), sdf=c(g.sdf), weight=c(g.weight),
        color=c(g.color), albedo=c(g.albedo), sdf_refined=c(g.sdf_refined), depth_min=g.depth_min,
        depth_max=g.depth_max, integration_weight_sample=g.integration_weight_sample,
    )


def _assert_grids_equal(a, b):
    assert a.voxel_size == b.voxel_size
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), err_msg=f)


def _boundary_grid(seed: int = 13) -> VoxelGrid:
    """The grid of `tests/test_grid.py::test_upsample_prep_bitwise_and_prebuilt_sparsify_layout`."""
    rng = np.random.default_rng(seed)
    coords = np.unique(rng.integers(-6, 6, size=(500, 3)).astype(np.int64), axis=0)
    g = VoxelGrid.from_coords(0.01, coords, sbr=True)
    n = g.num_voxels
    g.sdf = rng.normal(size=n).astype(np.float32) * 0.01
    g.weight = np.where(rng.random(n) < 0.8, rng.random(n) * 5, 0.0).astype(np.float32)
    g.color = rng.random((n, 3)).astype(np.float32)
    g.albedo = rng.random(n).astype(np.float32)
    g.sdf_refined = (rng.normal(size=n) * 0.01).astype(np.float32)
    return g


# ---------------------------------------------------------------------------
# UpsamplePrep
# ---------------------------------------------------------------------------


def test_upsample_prep_is_bitwise_the_serial_and_the_jax_upsample():
    g = _boundary_grid()
    prep = alg.UpsamplePrep(g, device="cpu")
    up_pre = alg.upsample(g, prep=prep, device="cpu")
    up_ref = alg.upsample(g, device="cpu")
    _assert_grids_equal(up_pre, up_ref)
    jg = _jgrid(g)
    jprep = j_alg.UpsamplePrep(jg, warm_program=False)
    jup = j_alg.upsample(jg, prep=jprep)
    _assert_grids_equal(up_pre, jup)
    np.testing.assert_array_equal(prep.idx, jprep.idx)
    np.testing.assert_array_equal(prep.order, jprep.order)
    assert prep.seconds > 0.0 and not prep.alive


@pytest.mark.parametrize("dense", [False, True], ids=["host", "dense"])
def test_prebuilt_sparsify_inputs_keep_the_same_voxels(dense):
    """The child's sparsify with the prep's inputs (either route) keeps the
    serial sparsify's voxel set and the JAX host sparsify's; the inputs of
    another grid object are refused, and so is a prep of another grid."""
    g = _boundary_grid()
    prep = alg.UpsamplePrep(g, dense=dense, device="cpu")
    up_pre = alg.upsample(g, prep=prep, device="cpu")
    up_ref = alg.upsample(g, device="cpu")
    shell = prep.shell_for(up_pre)
    assert shell is not None and shell.dense == dense and shell.grid is up_pre
    a = alg.clear_voxels_outside_thin_shell(up_pre, 0.008, device="cpu", shell=shell)
    b = alg.clear_voxels_outside_thin_shell(up_ref, 0.008, dense=dense, device="cpu")
    _assert_grids_equal(a, b)
    jb = j_alg.clear_voxels_outside_thin_shell(_jgrid(up_ref), 0.008, use_device=False)
    _assert_grids_equal(a, jb)
    assert 0 < a.num_voxels < up_pre.num_voxels

    assert prep.shell_for(up_ref) is None  # another grid object: refused
    with pytest.raises(ValueError, match="another grid"):
        alg.clear_voxels_outside_thin_shell(up_ref, 0.008, device="cpu", shell=shell)
    with pytest.raises(ValueError, match="route"):
        alg.clear_voxels_outside_thin_shell(up_pre, 0.008, dense=not dense, device="cpu", shell=shell)
    with pytest.raises(ValueError, match="another grid"):
        alg.upsample(g.clone(), prep=prep, device="cpu")
    with pytest.raises(ValueError, match="already returned"):
        alg.upsample(g, prep=prep, device="cpu")
    assert not prep.alive and not _prep_threads()


def _upsample_grid(case: str) -> VoxelGrid:
    """`_boundary_grid` (SBR) or its non-SBR copy; isolated voxels (no
    parent has another corner); a solid cube with every weight > 0."""
    if case in ("sbr", "non_sbr"):
        g = _boundary_grid(17)
        if case == "non_sbr":
            g.albedo = g.sdf_refined = None
        return g
    rng = np.random.default_rng(19)
    if case == "isolated":
        coords = 3 * np.unique(rng.integers(-8, 8, size=(300, 3)), axis=0)
    else:
        coords = np.stack(np.meshgrid(*[np.arange(-3, 4)] * 3, indexing="ij"), -1).reshape(-1, 3)
    g = VoxelGrid.from_coords(0.008, coords.astype(np.int64), sbr=True)
    n = g.num_voxels
    g.sdf = rng.normal(size=n).astype(np.float32) * 0.01
    g.weight = (rng.random(n) * 5 + 0.1).astype(np.float32)
    g.color = rng.random((n, 3)).astype(np.float32)
    g.albedo = rng.random(n).astype(np.float32)
    g.sdf_refined = (rng.normal(size=n) * 0.01).astype(np.float32)
    return g


@pytest.mark.parametrize("case", ["sbr", "non_sbr", "isolated", "solid"])
def test_upsample_kernel_plain_version_is_the_host_fields_in_key_order(case):
    """`ops.upsample.upsample_fields_plain`, the kernel's arithmetic on CPU
    tensors, is bit for bit the fields of `upsample(device="cpu")`, which
    launches nothing; each case's inputs hold what it is named for, and
    no parent count is a multiple of the kernel's 256-thread block."""
    g = _upsample_grid(case)
    idx, _, order = alg._upsample_skeleton(g)
    build.reset_launches()
    want = alg.upsample(g, device="cpu")
    assert build.LAUNCHES == dict.fromkeys(build.LAUNCHES, 0)
    names = up_ops.FIELDS if g.is_sbr else up_ops.FIELDS[:3]
    got = up_ops.upsample_fields_plain({k: torch.as_tensor(getattr(g, k)) for k in names}, torch.as_tensor(idx),
                                       torch.as_tensor(order))
    assert set(got) == set(names)
    for k in names:
        np.testing.assert_array_equal(got[k].numpy().view(np.int32), getattr(want, k).view(np.int32), err_msg=k)
    present = idx >= 0
    valid = present & (g.weight[np.maximum(idx, 0)] > 0.0)
    cnt = valid.sum(axis=1)
    assert g.num_voxels % 256 != 0 and (~present).any()
    if case in ("sbr", "non_sbr"):  # absent and zero-weight corners, parents on both sides of the 4-corner rule
        assert (present & ~valid).any() and (cnt <= 4).any() and (cnt > 4).any()
    elif case == "isolated":
        assert (cnt <= 1).all() and (want.weight == 0.0).all()
    else:
        assert (cnt == 8).any()


# ---------------------------------------------------------------------------
# LevelPrep
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def level():
    """A frame-bucketed level of the small sphere problem, with a fresh grid
    object (no memoized topology)."""
    kw = dict(num_observations=2, occlusion_distance=0.04, fix_poses=False, frame_bucketing="always")
    tp = build_sphere_problem(voxel_size=0.015, image_size=(64, 48), num_frames=3, num_observations=2,
                              perturb_sdf=0.002, perturb_albedo=0.05, cfg=RefinementConfig(**kw), device="cpu")
    return tp, kw


def _walk(obj, seen=None):
    """Every object reachable through tuples, lists, dicts, dataclasses and
    NamedTuples."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    yield obj
    if isinstance(obj, dict):
        children = list(obj.values())
    elif isinstance(obj, (tuple, list)):
        children = list(obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        children = [getattr(obj, f.name) for f in dataclasses.fields(obj)] + list(vars(obj).values())
    else:
        children = []
    for c in children:
        yield from _walk(c, seen)


def test_level_prep_is_bitwise_the_serial_and_the_jax_host_build(level, monkeypatch):
    monkeypatch.setenv("I3D_PREFETCH", "0")
    tp, kw = level
    grid, cfg = tp.grid.clone(), tp.cfg
    depths = tp.depths.numpy()
    h, w = depths.shape[1:]
    prep = opt.LevelPrep(grid, None, tp.params, cfg, depths, tp.thres_shell, 0, budget=BUDGET)
    prep.join()
    assert prep.seconds > 0.0 and not prep.alive

    # the products are host objects: numpy arrays, never tensors
    products = (prep.layout, prep.plan, prep.topo, prep.static, prep.inputs)
    assert not [o for o in _walk(products) if isinstance(o, torch.Tensor)]
    assert all(isinstance(a, np.ndarray) for a in prep.static)
    assert not prep.static.eg_sh.any()

    # against the serial host build
    layout = BlockLayout.build(grid)
    topo = LevelTopology.build(grid)
    for f in ("block_coords", "vox_slot", "nbr27"):
        np.testing.assert_array_equal(getattr(prep.layout, f), getattr(layout, f), err_msg=f)
    for f in dataclasses.fields(LevelTopology):
        np.testing.assert_array_equal(getattr(prep.topo, f.name), getattr(topo, f.name), err_msg=f.name)
    inputs = opt.plan_inputs(tp.params, depths, w, h, 0)
    fb, reason, chunks = opt._plan_level(layout, inputs, cfg, grid.voxel_size, tp.thres_shell, BUDGET)
    assert fb is not None and (reason, chunks) == prep.plan[1:]
    np.testing.assert_array_equal(prep.plan[0], fb)
    static = fill_voxel_sh(prep.static, prep.layout, tp.voxel_sh)
    for name, got, want in zip(static._fields, static, level_static_host(layout, grid, topo, tp.voxel_sh)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=name)

    # against the JAX package's host build of the same level
    jgrid = _jgrid(grid)
    jlayout = JBlockLayout.build(jgrid, halo_table=False)
    np.testing.assert_array_equal(prep.layout.vox_slot, jlayout.vox_slot)
    jtopo = JLevelTopology.build(jgrid)
    jst = j_build_level_static(jlayout, jgrid, jtopo, tp.voxel_sh, device=False)
    for name, got, want in zip(static._fields, static, jst):
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
    jfb, jreason, jchunks = j_plan_eg_layout(
        jlayout, inputs.poses, inputs.intr, JRefinementConfig(**kw), w, h, grid.voxel_size, tp.thres_shell,
        depths, budget=BUDGET,
    )
    assert (jreason, jchunks) == prep.plan[1:]
    np.testing.assert_array_equal(prep.plan[0], jfb)


def test_optimize_level_with_a_prep_is_bitwise_the_serial_level(level):
    """`optimize_level(prep=)` (a full prep, then a `program_only` one on its
    layout) against the serial level: costs, tries and parameters bitwise."""
    tp, _ = level
    cfg = dataclasses.replace(tp.cfg, iterations=1, lm_steps=4)
    depths = tp.depths.numpy()
    args = (None, tp.params, cfg, tp.cam, tp.depths, tp.images, tp.voxel_sh, tp.thres_shell, 0)
    runs = {}
    for mode in ("serial", "prep", "program_only"):
        grid = tp.grid.clone()
        prep = None
        if mode != "serial":
            layout = BlockLayout.build(grid) if mode == "program_only" else None
            prep = opt.LevelPrep(grid, None, tp.params, cfg, depths, tp.thres_shell, 0, budget=BUDGET, layout=layout,
                                 program_only=mode == "program_only")
        runs[mode] = opt.optimize_level(grid, *args, cg_iters=4, budget=BUDGET, device="cpu", prep=prep)
    p0, mu0, s0 = runs["serial"]
    for mode in ("prep", "program_only"):
        p, mu, st = runs[mode]
        assert (st.costs_before, st.costs_after, st.tries, st.mus, st.reason, st.bucket_blocks) == (
            s0.costs_before, s0.costs_after, s0.tries, s0.mus, s0.reason, s0.bucket_blocks)
        assert mu == mu0 and st.prefetch_seconds > 0.0
        for a, b in zip(p, p0):
            assert torch.equal(a, b)
    assert s0.prefetch_seconds == 0.0 and s0.bucket_blocks > 0
    with pytest.raises(ValueError, match="budget"):
        prep = opt.LevelPrep(tp.grid, None, tp.params, cfg, depths, tp.thres_shell, 0, budget=BUDGET)
        opt.optimize_level(tp.grid, *args, cg_iters=4, budget=BUDGET / 2, device="cpu", prep=prep)
    with pytest.raises(ValueError, match="another level"):
        prep = opt.LevelPrep(tp.grid, None, tp.params, cfg, depths, tp.thres_shell, 1, budget=BUDGET)
        opt.optimize_level(tp.grid, *args, cg_iters=4, device="cpu", prep=prep)
    assert not _prep_threads()


def test_the_topology_memo_builds_a_grid_once_under_contention(level, monkeypatch):
    """16 threads ask for one grid's stencil tables at once, switching every
    microsecond: `LevelTopology.build` runs once and every thread gets the
    same tables (a prep thread and the main thread may both ask)."""
    import sys

    from intrinsic3d_torch.refine import assembly

    tp, _ = level
    grid, builds, got = tp.grid.clone(), [], []
    real = assembly.LevelTopology.build
    monkeypatch.setattr(assembly.LevelTopology, "build", classmethod(lambda cls, g: builds.append(g) or real(g)))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: got.append(assembly.level_topology(grid))) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and len(got) == 16 and all(t is got[0] for t in got)


class _TorchCallRecorder:
    """A profile hook for threads started while it is installed: records
    every call from a non-main thread into torch (Python code under the
    torch package, or a builtin of a torch module)."""

    def __init__(self):
        self.calls = []
        self.root = os.path.dirname(torch.__file__) + os.sep

    def __call__(self, frame, event, arg):
        if threading.current_thread() is threading.main_thread():
            return
        if event == "call" and frame.f_code.co_filename.startswith(self.root):
            self.calls.append(f"{frame.f_code.co_filename}:{frame.f_code.co_name}")
        elif event == "c_call" and str(getattr(arg, "__module__", "") or "").startswith("torch"):
            self.calls.append(repr(arg))


class _MakesATensor(HostPrep):
    def __init__(self):
        super().__init__("makes a tensor")

    def _prepare(self):
        torch.zeros(3)


def test_prep_threads_call_nothing_of_torch(level):
    """No CUDA call, no collective and no tensor on a prep thread: profiled,
    neither prep calls into torch (the recorder does see a thread that
    makes a tensor)."""
    tp, _ = level
    rec = _TorchCallRecorder()
    threading.setprofile(rec)
    try:
        _MakesATensor().join()
        assert rec.calls, "the recorder missed a tensor made on a thread"
        rec.calls.clear()
        preps = [opt.LevelPrep(tp.grid.clone(), None, tp.params, tp.cfg, tp.depths.numpy(), tp.thres_shell, 0,
                               budget=BUDGET),
                 alg.UpsamplePrep(_boundary_grid(), dense=True, device="cpu"),
                 alg.UpsamplePrep(_boundary_grid(), dense=False, device="cpu")]
        for p in preps:
            p.join()
    finally:
        threading.setprofile(None)
    assert rec.calls == []
    assert preps[0].static is not None and preps[1].shell.flat is not None and preps[2].shell.support is not None


def test_a_prep_exception_reraises_at_the_join(level, monkeypatch):
    tp, _ = level

    def boom(*args, **kw):
        raise RuntimeError("boom in the prep")

    monkeypatch.setattr(opt, "level_static_host", boom)
    prep = opt.LevelPrep(tp.grid.clone(), None, tp.params, tp.cfg, tp.depths.numpy(), tp.thres_shell, 0,
                         budget=BUDGET)
    with pytest.raises(RuntimeError, match="boom in the prep"):
        opt.optimize_level(prep.grid, None, tp.params, tp.cfg, tp.cam, tp.depths, tp.images, tp.voxel_sh,
                           tp.thres_shell, 0, device="cpu", prep=prep)
    monkeypatch.setattr(alg, "shell_inputs", boom)
    g = _boundary_grid()
    bprep = alg.UpsamplePrep(g, device="cpu")
    with pytest.raises(RuntimeError, match="boom in the prep"):
        alg.upsample(g, prep=bprep, device="cpu")
    assert not _prep_threads()


# ---------------------------------------------------------------------------
# The whole refinement
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fused():
    return app_fusion.run(small_refinement_sensor(), FusionConfig(voxel_size=SMALL_VOXEL, discont_window_size=0),
                          device="cpu")


def _refine(fused, prefetch: bool):
    stats, levels = {}, []
    engine = Intrinsic3D(SMALL_REFINEMENT, small_refinement_sensor(), list(range(5)), cg_iters=SMALL_CG_ITERS,
                         device="cpu", prefetch=prefetch)
    engine.add_callback(lambda i: levels.append((i.grid_level, i.pyramid_level, i.stats)))
    grid = engine.refine(fused.clone(), stats=stats)
    return grid, levels, engine.sensor, stats


def test_refine_with_prefetch_is_bitwise_the_serial_refine(fused):
    """The end-to-end scene (2 grid × 2 pyramid levels) refined with the
    level pipeline on and off: the same schedule, per-level plans, costs,
    tries and μ, refined fields and sensor poses and camera, bit for bit; the
    pipeline's phases are recorded and no prep thread outlives `refine`."""
    on, off = _refine(fused, True), _refine(fused, False)
    assert not _prep_threads()
    _assert_grids_equal(on[0], off[0])
    assert [lv[:2] for lv in on[1]] == [lv[:2] for lv in off[1]] == [(1, 1), (1, 0), (0, 0)]
    for (_, _, a), (_, _, b) in zip(on[1], off[1]):
        assert (a.costs_before, a.costs_after, a.tries, a.mus, a.reason, a.num_blocks, a.bucket_blocks) == (
            b.costs_before, b.costs_after, b.tries, b.mus, b.reason, b.num_blocks, b.bucket_blocks)
        assert a.prefetch_seconds > 0.0 and b.prefetch_seconds == 0.0
    for i in range(5):
        np.testing.assert_array_equal(on[2].pose(i), off[2].pose(i))
    cam_on, cam_off = on[2].color_cam, off[2].color_cam
    assert [cam_on.fx, cam_on.fy, cam_on.cx, cam_on.cy] == [cam_off.fx, cam_off.fy, cam_off.cx, cam_off.cy]
    pipeline = {"prefetch[p1v", "prefetch[p0v", "upsample_prep[g1]"}
    assert all(any(k.startswith(p) for k in on[3]) for p in pipeline)
    assert not any(k.startswith(p) for k in off[3] for p in pipeline)
    assert [k for k in on[3] if not k.startswith(("prefetch[", "upsample_prep["))] == list(off[3])


def test_a_failing_prep_fails_the_refinement(fused, monkeypatch):
    """A prep that raises fails `refine` with its exception (no serial
    rebuild behind it), and every prep thread is joined."""

    def boom(*args, **kw):
        raise RuntimeError("boom in the level prep")

    monkeypatch.setattr(opt, "level_static_host", boom)
    engine = Intrinsic3D(SMALL_REFINEMENT, small_refinement_sensor(), list(range(5)), cg_iters=SMALL_CG_ITERS,
                         device="cpu")
    with pytest.raises(RuntimeError, match="boom in the level prep"):
        engine.refine(fused.clone())
    assert not _prep_threads() and not engine._preps
