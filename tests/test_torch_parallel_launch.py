"""The rank launcher and mesh set-up of `intrinsic3d_torch.parallel`.

This file imports torch and numpy only, so it also runs on a machine
without JAX. The test marked `cuda` needs the card and skips without one;
run it there with

    python -m pytest tests/test_torch_parallel_launch.py -m cuda --noconftest -o addopts="" -q

(`--noconftest`: the suite's conftest imports JAX). It runs two ranks over
gloo on the one card, each step held to the single-device step at the JAX
dry run's bar (costs rtol 1e-4).
"""

import pytest
import torch

from intrinsic3d_torch.parallel import dryrun
from intrinsic3d_torch.parallel.sharding import init_mesh


def test_init_mesh_takes_an_explicit_backend():
    with pytest.raises(ValueError, match="backend"):
        init_mesh(1, 0, backend="mpi", init_method="file:///nonexistent", device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        init_mesh(1, 0, backend="nccl", init_method="file:///nonexistent", device="cpu")


def test_a_failing_rank_fails_the_launch(tmp_path):
    """A layout whose block count does not divide over the ranks: every
    rank raises, and the launch raises with the rank's error."""
    bprob = dryrun.block_problem_inputs(dryrun.small_problem(), blocks_multiple=1)
    nb = len(bprob["bp"][0]) - 1
    world = 2 if nb % 2 else 3
    assert nb % world
    with pytest.raises(Exception, match="not divisible"):
        dryrun.launch(dryrun.halo_task, world, backend="gloo", device="cpu",
                      init_method=f"file://{tmp_path}/rendezvous", args=(bprob,), timeout=120.0)


def test_ranks_past_the_timeout_are_stopped(tmp_path):
    """Ranks still running at the timeout are terminated and the launch
    raises instead of waiting."""
    with pytest.raises(TimeoutError):
        dryrun.launch(dryrun.mesh_loop_task, 2, backend="gloo", device="cpu",
                      init_method=f"file://{tmp_path}/rendezvous", args=(dryrun.sphere_scene(), dryrun.MESH_LOOP_CFG),
                      timeout=1.0)


def test_streamed_mesh_level_tracks_the_single_device(tmp_path):
    """A level planned to stream its E_g elements in frame chunks streams
    each rank's brick in the same chunks under a mesh, and its costs hold
    the single device's streamed run at the JAX dry run's bars
    (`costs_before` rtol 1e-4, `costs_after` rtol 1e-3). The budget is the
    planner's own streaming arithmetic for two chunks of the exact buckets."""
    import dataclasses

    import numpy as np

    from intrinsic3d_torch.config import RefinementConfig
    from intrinsic3d_torch.grid.blocks import BlockLayout
    from intrinsic3d_torch.refine import optimizer as opt

    lp = dryrun.level_inputs(dryrun.small_problem())
    grid = dryrun._grid(lp["grid"])
    cfg = dataclasses.replace(RefinementConfig(**lp["cfg"]), frame_bucketing="always")
    poses, intr = lp["params"][2], lp["params"][3].astype(np.float64)
    h, w = lp["depths"].shape[1:]

    def plan(budget):
        return opt.plan_eg_layout(BlockLayout.build(grid, blocks_multiple=8), poses, intr, cfg, w, h,
                                  grid.voxel_size, lp["thres_shell"], lp["depths"], budget=budget, device="cpu")

    k, el_frame = len(poses), plan(1e12)[0].shape[1] * 512
    budget = k * el_frame * opt._EG_CHUNK_PERSIST_BYTES + 1.5 * el_frame * opt._EG_CHUNK_TRANSIENT_BYTES
    assert k == 2 and plan(budget)[2] == 2
    out = dryrun.launch(dryrun.pipeline_task, 2, backend="gloo", device="cpu",
                        init_method=f"file://{tmp_path}/rendezvous", timeout=300.0,
                        args=(lp, ("always",), 2, 4, 4, True, budget))
    for r in out:
        got, want = r["always"]["mesh"], r["always"]["single"]
        assert got["eg_chunks"] == want["eg_chunks"] == 2
        np.testing.assert_allclose(got["costs_before"], want["costs_before"], rtol=1e-4)
        np.testing.assert_allclose(got["costs_after"], want["costs_after"], rtol=1e-3)
        assert all(c1 <= c0 for c0, c1 in zip(got["costs_before"], got["costs_after"]))


def test_mesh_prefetch_is_bitwise_the_serial_build(tmp_path):
    """`Intrinsic3D(mesh=)` on two gloo ranks over CPU tensors, the level
    preps on (each rank's statics, plan and stencil tables built on a thread
    during the sharded SVSH) and off, both in one launch: on every rank the
    refined fields and each level's costs are bit for bit the same."""
    import numpy as np

    scene, cfg = dryrun.sphere_scene(), dryrun.MESH_LOOP_CFG
    calls = [(name, dryrun.mesh_loop_task, (scene, cfg), dict(single=False, prefetch=on))
             for name, on in (("on", True), ("off", False))]
    out = dryrun.launch(dryrun.run_tasks, 2, backend="gloo", device="cpu",
                        init_method=f"file://{tmp_path}/rendezvous", args=(calls,), timeout=300.0)
    for r in out:
        on, off = r["on"]["mesh"], r["off"]["mesh"]
        for key in ("coords", "sdf_refined", "albedo", "color"):
            np.testing.assert_array_equal(on[key], off[key], err_msg=key)
        assert on["voxel_size"] == off["voxel_size"]
        assert [lv["level"] for lv in on["levels"]] == ["g1p0", "g0p0"]
        assert on["levels"] == off["levels"]
    assert out[0]["on"]["mesh"]["levels"] == out[1]["on"]["mesh"]["levels"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ranks share the card over gloo")
    return torch.device("cuda")


@pytest.mark.cuda
def test_two_ranks_share_the_card_over_gloo(cuda_device, tmp_path):
    bprob = dryrun.block_problem_inputs(dryrun.small_problem(), blocks_multiple=2)
    out = dryrun.launch(dryrun.spmd_step_task, 2, backend="gloo", device="cuda",
                        init_method=f"file://{tmp_path}/rendezvous", args=(bprob,), timeout=300.0)
    for r in out:
        sp, one = r["spmd"], r["single"]
        assert sp["cost1"] < sp["cost0"]
        assert sp["cost0"] == pytest.approx(one["cost0"], rel=1e-4)
        assert sp["cost1"] == pytest.approx(one["cost1"], rel=1e-4)
        assert r["collectives"]["all_to_all"] > 0
    assert out[0]["spmd"]["cost1"] == out[1]["spmd"]["cost1"]
