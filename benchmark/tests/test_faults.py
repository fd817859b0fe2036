"""The whole run on the CPU at the tiny size with the timed path broken
underneath: each fault this cell can have makes `correct` false."""

import numpy as np
import pytest

from benchmark import run

SEED = 2**31 + 13


def _state_unchanged(mp):
    from intrinsic3d_torch.refine.optimizer import LevelSetup

    step = LevelSetup.outer_step

    def no_op(self, params, *a, **kw):
        out = step(self, params, *a, **kw)
        return (params, out[1], out[1]) + tuple(out[3:])

    mp.setattr(LevelSetup, "outer_step", no_op)


def _state_dropped(mp):
    import intrinsic3d_torch.refine.intrinsic3d as engine

    level = engine.optimize_level

    def dropped(grid, topo, params, *a, **kw):
        _, mu, stats = level(grid, topo, params, *a, **kw)
        return params, mu, stats

    mp.setattr(engine, "optimize_level", dropped)


def _half_the_frames(mp):
    from intrinsic3d_torch.grid.fusion import FusionVolume

    integrate = FusionVolume.integrate_batch
    mp.setattr(FusionVolume, "integrate_batch", lambda self, d, c, p: integrate(self, d[::2], c[::2], p[::2]))


def _answer_altered(mp):
    from intrinsic3d_torch.refine.intrinsic3d import Intrinsic3D

    write_back = Intrinsic3D._write_back

    def altered(self, grid, params):
        write_back(self, grid, params)
        grid.sdf_refined = (grid.sdf_refined + np.float32(0.02 * grid.voxel_size)).astype(np.float32)

    mp.setattr(Intrinsic3D, "_write_back", altered)


def _mesh_altered(mp):
    from intrinsic3d_torch import visualization

    save = visualization.save_ply
    mp.setattr(visualization, "save_ply", lambda name, v, f, c=None: save(name, v[: len(v) // 2], f[:0],
                                                                          None if c is None else c[: len(v) // 2]))


@pytest.mark.parametrize("workload,fault,caught_by", [
    ("tiny.reconstruct", _state_unchanged, "refine_gain"),
    ("tiny.reconstruct", _state_dropped, "cost_end_gap"),
    ("tiny.reconstruct", _half_the_frames, "fusion_gap"),
    ("tiny.reconstruct", _answer_altered, "cost_end_gap"),
    ("tiny.export", _mesh_altered, "mesh_missing_share"),
], ids=["state_unchanged", "state_dropped", "half_the_frames", "answer_altered", "mesh_altered"])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, workload, fault, caught_by):
    fault(monkeypatch)
    res = run.execute(workload, SEED, 0.0, False, device="cpu", root=tiny_root)
    assert not res["correct"]
    c = res["checks"][caught_by]
    assert c["value"] > c["limit"], res["checks"]
