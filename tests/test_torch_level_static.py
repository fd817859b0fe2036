"""A block level's statics from its layout alone (`ops.level_static`), on the CPU.

`level_static_plain` is the `level_static` kernel's algorithm in numpy: the
slot-to-voxel map and each slot's +x, +y and +z neighbour slot through the
layout's `nbr27`, with no `LevelTopology`. It is held bit for bit to the host
build the CPU path keeps (`level_static_host` with the per-voxel SH, which
reads the stencil tables) on the upsample tests' boundary grid, the
end-to-end scene's two grid levels and a grid built for the edge cases. The
kernel itself runs on the card only (`tests/test_torch_kernels.py`, marked
`cuda`). Where a level builds its statics is the engine's choice by device:
a CPU `LevelPrep` still builds the stencil tables and the host statics.
"""

import numpy as np
import pytest
import torch

from intrinsic3d_torch.apps import app_fusion
from intrinsic3d_torch.config import FusionConfig, RefinementConfig
from intrinsic3d_torch.grid import algorithms as alg
from intrinsic3d_torch.grid.blocks import BlockLayout
from intrinsic3d_torch.grid.voxel_grid import VoxelGrid
from intrinsic3d_torch.ops.level_static import inputs_of, level_static_plain
from intrinsic3d_torch.refine import assembly, device_assembly, intrinsic3d
from intrinsic3d_torch.refine import optimizer as opt
from intrinsic3d_torch.refine.assembly import LevelTopology
from intrinsic3d_torch.refine.device_assembly import level_static_host, statics_on_card
from intrinsic3d_torch.synthetic import (
    SMALL_CG_ITERS,
    SMALL_REFINEMENT,
    SMALL_VOXEL,
    build_sphere_problem,
    small_refinement_sensor,
)

from torch_support import one_torch_thread  # noqa: F401

# a colour whose float32 luma (0.299 r + 0.587 g) + 0.114 b is exactly 0
# though its channels are not: the weights' 1e-12 stands in for the luma
ZERO_LUMA = (1.0, 0.0, -2.622807)


def _boundary_grid(seed: int = 13) -> VoxelGrid:
    """The grid of `tests/test_grid.py::test_upsample_prep_bitwise_and_prebuilt_sparsify_layout`."""
    rng = np.random.default_rng(seed)
    coords = np.unique(rng.integers(-6, 6, size=(500, 3)).astype(np.int64), axis=0)
    g = VoxelGrid.from_coords(0.01, coords, sbr=True)
    n = g.num_voxels
    g.sdf = rng.normal(size=n).astype(np.float32) * 0.01
    g.weight = np.where(rng.random(n) < 0.8, rng.random(n) * 5, 0.0).astype(np.float32)
    g.color = rng.random((n, 3)).astype(np.float32)
    return g


def _edge_grid(seed: int = 5) -> VoxelGrid:
    """A 27³ box about the origin with a fifth of its voxels dropped: pairs
    across every face of the 8³ blocks (negative coordinates included),
    absent neighbours inside and at the edge, and a block count that
    `blocks_multiple` pads. Colours 0..255 with black voxels, voxels of
    `ZERO_LUMA`, NaN channels (non-finite weights) and pairs whose weight
    clamps at 0.01; weights zero and NaN, sdf values -0.0 and NaN."""
    rng = np.random.default_rng(seed)
    r = np.arange(-10, 17)
    c = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    g = VoxelGrid.from_coords(0.01, c[rng.random(len(c)) > 0.2])
    n = g.num_voxels
    g.sdf = rng.normal(size=n).astype(np.float32) * 0.02
    g.sdf[rng.random(n) < 0.05] = -0.0
    g.sdf[rng.random(n) < 0.01] = np.nan
    g.weight = np.where(rng.random(n) < 0.85, rng.random(n) * 5, 0.0).astype(np.float32)
    g.weight[rng.random(n) < 0.01] = np.nan
    color = (rng.random((n, 3)) * 255).astype(np.float32)
    color[rng.random(n) < 0.05] = 0.0
    color[rng.random(n) < 0.05] = ZERO_LUMA
    color[rng.random(n) < 0.02, rng.integers(0, 3)] = np.nan
    g.color = color
    return g


def _fused() -> VoxelGrid:
    return app_fusion.run(small_refinement_sensor(), FusionConfig(voxel_size=SMALL_VOXEL, discont_window_size=0),
                          device="cpu")


def scene_grid_levels() -> dict:
    """The end-to-end scene's two grid levels: the coarsest (the fused grid
    as the refinement takes it) and the finest (upsampled and sparsified)."""
    coarse = _fused().to_sbr()
    fine = alg.upsample(coarse, device="cpu")
    fine = alg.clear_voxels_outside_thin_shell(fine, SMALL_REFINEMENT.thin_shell_factor * fine.voxel_size,
                                               device="cpu")
    return {"g1": coarse, "g0": fine}


@pytest.fixture(scope="module")
def scene_levels():
    return scene_grid_levels()


def _sh(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, 9)).astype(np.float32)


def _assert_bitwise(got, want):
    for name, a, b in zip(("occ", "valid", "vpos", "es_ref", "eg_sh", "ea_chroma"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(np.ascontiguousarray(a).view(np.int32), np.ascontiguousarray(b).view(np.int32),
                                      err_msg=name)


def _check_grid(grid: VoxelGrid, block: int = 8, blocks_multiple: int = 8):
    layout = BlockLayout.build(grid, block=block, blocks_multiple=blocks_multiple)
    sh = _sh(grid.num_voxels, grid.num_voxels)
    want = level_static_host(layout, grid, LevelTopology.build(grid), sh)
    _assert_bitwise(level_static_plain(*inputs_of(layout, grid, sh), layout.block), want)
    return layout, want


@pytest.mark.parametrize("case", ["boundary", "edges", "edges-b3"])
def test_plain_is_bitwise_the_host_build(case):
    grid = _boundary_grid() if case == "boundary" else _edge_grid()
    block = 3 if case == "edges-b3" else 8
    layout, want = _check_grid(grid, block=block, blocks_multiple=8 if block == 8 else 1)
    occ = want.occ[:-1].reshape(-1)
    assert occ.sum() == grid.num_voxels and not want.occ[-1].any() and not want.valid[-1].any()
    ea = want.ea_chroma.reshape(3, -1)
    assert (ea > 0.0).sum(axis=1).min() > 0
    if case != "boundary":
        # pad blocks, pairs across block faces, the 0.01 clamp, zero weights
        # of non-finite pairs
        assert layout.num_blocks % 8 == 0 or block != 8
        assert layout.num_blocks > len(np.unique(np.floor_divide(grid.coords, block), axis=0)) or block != 8
        lane = np.arange(ea.shape[1]) % block**3
        edge = [(lane // block**2 == block - 1), (lane // block % block == block - 1), (lane % block == block - 1)]
        assert all(((ea[a] > 0.0) & edge[a]).any() for a in range(3))
        assert (ea == np.float32(0.01)).any()
        nan_vox = np.isnan(grid.color).any(axis=1)
        assert nan_vox.any() and not ea[:, layout.vox_slot[nan_vox]].any()


@pytest.mark.parametrize("level", ["g1", "g0"])
def test_plain_is_bitwise_the_host_build_on_the_scene_levels(scene_levels, level):
    grid = scene_levels[level]
    assert grid.num_voxels > 1000
    _check_grid(grid)


def test_statics_on_card_follows_the_device():
    assert statics_on_card(torch.device("cuda"))
    assert statics_on_card("cuda:0")
    assert not statics_on_card("cpu")
    assert not statics_on_card("cuda", mesh=object())


def test_a_cpu_level_prep_still_builds_the_topology_and_the_host_statics():
    """On the CPU the prep's products are today's: the stencil tables (the
    grid's topology memo filled) and the host statics with zero SH."""
    cfg = RefinementConfig(num_observations=2, occlusion_distance=0.04, fix_poses=False)
    tp = build_sphere_problem(voxel_size=0.03, image_size=(32, 24), num_frames=2, num_observations=2, cfg=cfg,
                              device="cpu")
    grid = tp.grid.clone()
    prep = opt.LevelPrep(grid, None, tp.params, cfg, tp.depths.numpy(), tp.thres_shell, 0, budget=1e12)
    prep.join()
    assert prep.host_static and prep.topo is not None and prep.static is not None
    assert grid.__dict__.get("_topo_cache") is prep.topo
    assert not prep.static.eg_sh.any() and prep.static.ea_chroma.any()


def _refine(fused: VoxelGrid, prefetch: bool):
    levels = []
    engine = intrinsic3d.Intrinsic3D(SMALL_REFINEMENT, small_refinement_sensor(), list(range(5)),
                                     cg_iters=SMALL_CG_ITERS, device="cpu", prefetch=prefetch)
    engine.add_callback(lambda i: levels.append((i.grid_level, i.pyramid_level, i.stats.costs_after)))
    return engine.refine(fused.clone()), levels, engine.sensor


def test_the_card_route_rehearsed_on_the_cpu_is_bitwise_the_host_route(monkeypatch):
    """The end-to-end scene refined on the CPU through the card's route,
    with the kernel's plain version standing in for the kernel (every
    single-device level builds its statics from its layout after the prep's
    join; no stencil table is built), with the level pipeline on and off:
    bit for bit the refinement through the host build."""
    fused = _fused()
    want, want_levels, want_sensor = _refine(fused, prefetch=True)

    calls, tables = [], []

    def stand_in(*args):
        *tensors, block = args
        calls.append(block)
        return tuple(torch.as_tensor(a) for a in level_static_plain(*(t.numpy() for t in tensors), block))

    for module in (device_assembly, opt, intrinsic3d):
        monkeypatch.setattr(module, "statics_on_card", lambda device, mesh=None: mesh is None)
    monkeypatch.setattr(device_assembly, "level_static_kernel", stand_in)
    monkeypatch.setattr(assembly.LevelTopology, "build", classmethod(lambda cls, g: tables.append(g)))
    for prefetch in (True, False):
        calls.clear()
        got, levels, sensor = _refine(fused, prefetch)
        assert tables == [] and len(calls) == len(levels) == 3
        assert levels == want_levels
        for f in ("coords", "sdf", "weight", "color", "albedo", "sdf_refined"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        for i in range(5):
            np.testing.assert_array_equal(sensor.pose(i), want_sensor.pose(i))
