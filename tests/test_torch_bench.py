"""The port's benchmark twins (`intrinsic3d_torch.bench`,
`intrinsic3d_torch.bench_pipeline`) and `intrinsic3d_torch.timer` against the
JAX package's `bench.py`, `bench_pipeline.py` and `timer.py`, on the CPU at
a tiny size.

The JSON lines must carry exactly the keys of the JAX scripts' lines (listed
below from `bench.py:133-149` and `bench_pipeline.py:258-300`), the active
E_g count must equal the JAX flat assembly's on the same problem, the
pipeline's phases must be named as the refinement engine's `stats` dict
names them, and the timer must behave as JAX's on a scripted sequence.
"""

import contextlib
import io
import json
import time

import numpy as np
import pytest
import torch

from intrinsic3d_tpu import timer as jtimer
from intrinsic3d_tpu.config import RefinementConfig as JRefinementConfig
from intrinsic3d_tpu.synthetic import build_sphere_problem as j_build_sphere_problem

from intrinsic3d_torch import bench, bench_pipeline
from intrinsic3d_torch import timer as ttimer
from intrinsic3d_torch.refine.intrinsic3d import Intrinsic3D
from intrinsic3d_torch.synthetic import BENCH_PROBLEM

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
BENCH_DETAIL_KEYS = {
    "active_eg_residuals", "num_voxels", "outer_iteration_s", "includes_device_assembly", "cg_iters",
    "mean_lm_tries", "device",
}
PIPELINE_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
PIPELINE_DETAIL_KEYS = {
    "headline_mode", "stages_s", "mode_best_s", "runs", "chip_claim_s", "total_with_claim_s", "dataset_gen_s",
    "frames", "keyframes_selected", "image", "grid_levels", "fused_voxels", "final_voxels", "final_voxel_size_m",
    "fused_mesh_faces", "refined_mesh_faces", "refined_mesh_err_rms_m", "refined_mesh_err_p95_m", "device",
}
PIPELINE_RUN_KEYS = {"mode", "total_s", "stages_s", "phases_s", "stall_excess_s"}
STAGES = {"keyframes", "fusion", "refinement"}

TINY_BENCH_PROBLEM = dict(BENCH_PROBLEM, voxel_size=0.02, image_size=(64, 48), num_frames=2)
PIPELINE_ARGS = "--frames 6 --size 80x60 --voxel 0.02 --levels 1 --iters 1 --modes auto --repeats 1".split()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test files run in parallel worker processes: one intra-op thread per
    process keeps torch from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv):
    """`main(argv, device="cpu")`: (returned dict, last stdout line parsed)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv, device="cpu")
    return result, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def bench_line():
    """`bench.py`'s twin on a tiny problem (the benchmark's own settings at
    2 cm voxels, 2 frames of 64×48)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "BENCH_PROBLEM", TINY_BENCH_PROBLEM)
        return _run(bench.main, [])


@pytest.fixture(scope="module")
def pipeline_line():
    """The pipeline twin's line, with the `stats` dict the twin handed the
    refinement engine (constructor and `refine`) in the same run."""
    captured = []

    class Engine(Intrinsic3D):
        def __init__(self, *a, stats=None, **kw):
            captured.append(stats)
            super().__init__(*a, stats=stats, **kw)

        def refine(self, fused, stats=None):
            assert stats is captured[-1]
            return super().refine(fused, stats=stats)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench_pipeline, "Intrinsic3D", Engine)
        result, line = _run(bench_pipeline.main, PIPELINE_ARGS)
    (stats,) = captured
    assert isinstance(stats, dict)
    return result, line, stats


def test_bench_line_has_the_jax_keys(bench_line):
    result, line = bench_line
    assert line == json.loads(json.dumps(result))
    assert set(line) == BENCH_KEYS
    assert set(line["detail"]) == BENCH_DETAIL_KEYS
    assert line["metric"] == "gn_voxel_residual_evals_per_s" and line["value"] > 0.0
    assert line["detail"]["device"] == "cpu" and line["detail"]["cg_iters"] == 12
    # the accounting: evals = active · (1 + 29 + (2·cg + 1)·mean tries) per iteration
    d = line["detail"]
    evals_per_s = d["active_eg_residuals"] * (1 + 29 + 25 * d["mean_lm_tries"]) / d["outer_iteration_s"]
    np.testing.assert_allclose(line["value"], evals_per_s, rtol=1e-2)


def test_bench_active_count_matches_jax(bench_line):
    """`active_eg_residuals` is the flat assembly's count, as JAX's
    `build_sphere_problem(...).assemble()` gives it on the same problem."""
    _, line = bench_line
    cfg = JRefinementConfig(
        num_observations=5, occlusion_distance=0.02, fix_poses=False, fix_intrinsics=False, fix_distortion=False
    )
    prob = j_build_sphere_problem(**TINY_BENCH_PROBLEM, cfg=cfg)
    asm, _ = prob.assemble()
    n_active = int(np.sum(np.asarray(asm.eg_w) > 0))
    assert n_active > 100
    assert line["detail"]["active_eg_residuals"] == n_active
    assert line["detail"]["num_voxels"] == prob.grid.num_voxels


def test_pipeline_line_has_the_jax_keys(pipeline_line):
    result, line, _ = pipeline_line
    assert line == json.loads(json.dumps(result))
    assert set(line) == PIPELINE_KEYS
    assert set(line["detail"]) == PIPELINE_DETAIL_KEYS
    assert line["metric"] == "pipeline_wall_clock_s" and line["value"] > 0.0
    d = line["detail"]
    assert set(d["stages_s"]) == STAGES and set(d["mode_best_s"]) == {"auto"}
    assert len(d["runs"]) == 1
    for run in d["runs"]:
        assert set(run) == PIPELINE_RUN_KEYS and set(run["stages_s"]) == STAGES
        assert run["phases_s"] and run["stall_excess_s"] == 0.0
    assert d["device"] == "cpu" and d["frames"] == 6 and d["image"] == "80x60" and d["grid_levels"] == 1
    assert d["final_voxel_size_m"] == pytest.approx(0.02)
    assert np.isfinite(d["refined_mesh_err_rms_m"]) and d["refined_mesh_err_rms_m"] < 0.02


def test_pipeline_phases_are_the_engines_stats(pipeline_line):
    """`runs[].phases_s` carries the refinement's phases under the names
    (and, rounded, the seconds) the engine's `stats` dict records."""
    _, line, captured = pipeline_line
    phases = line["detail"]["runs"][0]["phases_s"]
    assert list(phases) == list(captured)
    assert {"pyramids", "initial_recolor", "sparsify[g0]", "topology[g0]", "svsh[g0p0]", "recolor[g0p0]"} <= set(phases)
    assert any(name.startswith("solve[p0v") for name in phases)
    assert any(name.startswith("level_setup[p0v") for name in phases)
    for name, seconds in captured.items():
        assert phases[name] == round(seconds, 2)


def test_timer_matches_jax():
    """The same scripted sequence through both timer modules."""
    def script(mod):
        mod.phases_reset()
        mod.record_phase("a", 1)
        mod.record_phase("b[g0]", 0.25)
        mod.record_phase("a", 2.5)
        snap = mod.phases_snapshot()
        mod.record_phase("c", 3.0)  # a snapshot is a copy
        pt = mod.PhaseTimer()
        for name in ("x", "y", "x"):
            with pt.phase(name):
                pass
        with pytest.raises(KeyError):
            with pt.phase("z"):
                raise KeyError("inside")  # the phase is still counted
        t = mod.Timer()
        time.sleep(0.001)
        t.stop()
        report = pt.report().split("; ")
        mod.phases_reset()
        return snap, dict(pt.counts), [r.split(":")[0] for r in report], t.elapsed() > 0.0, mod.phases_snapshot()

    assert script(ttimer) == script(jtimer)
