"""The metric readers' arithmetic on hand-made events, phases and jobs."""

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import harness, trace
from benchmark.check import surface_errors


def metric(name):
    return harness.load_metric(name)


def test_union_and_idle_share():
    dev = [(0.0, 1.0, "k"), (0.5, 2.0, "k"), (3.0, 4.0, "k"), (3.5, 3.6, "k"), (9.0, 12.0, "k")]
    assert trace.union(dev, 0.0, 10.0) == [(0.0, 2.0), (3.0, 4.0), (9.0, 10.0)]
    assert trace.busy_seconds(dev, 0.0, 10.0) == pytest.approx(4.0)
    assert trace.idle_gaps(dev, 0.0, 10.0) == [(4.0, 9.0), (2.0, 3.0)]
    ctx = SimpleNamespace(device=dev, traced=(0.0, 10.0), jobs=[1, 2])
    assert metric("device.idle_pct").read(ctx) == pytest.approx(60.0)


def test_idle_share_counts_a_gap_at_either_end():
    dev = [(2.0, 3.5, "k")]
    assert trace.idle_gaps(dev, 0.0, 5.0) == [(0.0, 2.0), (3.5, 5.0)]
    assert metric("device.idle_pct").read(SimpleNamespace(device=dev, traced=(0.0, 5.0), jobs=[1])) == 70.0


def test_launches_and_own_kernels_per_job():
    dev = [(0.0, 0.001, "void rows_vec_kernel<BicubicValueOp>(...)"), (0.1, 0.103, "fused_sweeps_kernel"),
           (0.2, 0.3, "Memcpy HtoD (Pageable -> Device)"), (0.3, 0.4, "Memset (Device)"),
           (0.4, 0.5, "void at::native::elementwise_kernel<...>")]
    ctx = SimpleNamespace(device=dev, jobs=[1, 2])
    assert metric("device.launches").read(ctx) == 1.5
    assert metric("kernels.own_ms").read(ctx) == pytest.approx(2.0)
    assert metric("kernels.own_ms").read(SimpleNamespace(device=dev[2:], jobs=[1])) is None


def test_gaps_are_named_by_the_host():
    host = [(0.0, 10.0, "job"), (0.0, 4.0, "fusion"), (4.0, 10.0, "refine"), (5.0, 7.0, "aten::nonzero"),
            (5.5, 6.5, "cudaStreamSynchronize")]
    assert trace.host_at(host, 6.0) == "refine: cudaStreamSynchronize"
    assert trace.host_at(host, 8.0) == "refine: no torch op"
    dev = [(0.0, 5.0, "k"), (7.0, 10.0, "k")]
    assert trace.named_gaps(dev, host, 0.0, 10.0) == [["refine: cudaStreamSynchronize", 2.0]]
    assert trace.window_of(host) == (0.0, 10.0)


def test_phase_sums_leave_out_the_solves_and_the_overlapped_threads():
    stats = {"pyramids": 0.5, "initial_recolor": 0.25, "sparsify[g1]": 0.125, "svsh[g1p1]": 1.0,
             "prefetch[p1v10]": 9.0, "level_setup[p1v10]": 0.5, "solve[p1v10]": 3.0, "recolor[g1p1]": 0.25,
             "upsample[g1]": 2.0, "upsample_prep[g1]": 7.0, "solve[p0v80]": 5.0}
    jobs = [SimpleNamespace(stats=stats), SimpleNamespace(stats=dict(stats, **{"upsample[g1]": 4.0}))]
    ctx = SimpleNamespace(jobs=jobs)
    assert metric("levels.host_s").read(ctx) == pytest.approx(4.625 + 1.0)
    assert metric("solve.finest_s").read(ctx) == 5.0
    assert metric("solve.coarse_s").read(ctx) == 3.0
    assert metric("levels.host_s").read(SimpleNamespace(jobs=[SimpleNamespace(stats=None)])) is None


def test_window_rate_and_pooled_median():
    ctx = SimpleNamespace(window_s=31.0, jobs=[1, 2])
    assert metric("reconstruct_s").read(ctx) == 15.5
    # voxels on the sphere (r = 0.12 m = 30 voxels around (0, 0, 150)) and
    # one outside the shell, which does not count
    on_sphere = np.array([[0, 0, 180], [0, 0, 120], [30, 0, 150], [-30, 0, 150], [0, 30, 150]])
    grids = []
    for errs in ([1e-4, 3e-4, 5e-4], [2e-4, 4e-4]):
        n = len(errs)
        g = SimpleNamespace(coords=np.concatenate([on_sphere[:n], [[0, 0, 150]]]), voxel_size=0.004,
                            weight=np.ones(n + 1, np.float32), sdf=np.zeros(n + 1, np.float32))
        true = np.linalg.norm(g.coords * np.float64(np.float32(0.004)) - [0, 0, 0.6], axis=-1) - 0.12
        g.sdf_refined = (true + np.asarray(errs + [0.0])).astype(np.float32)
        grids.append(g)
    scene = dict(center=[0.0, 0.0, 0.6], radius=0.12)
    assert np.sort(surface_errors(grids[0], scene)) == pytest.approx([1e-4, 3e-4, 5e-4], rel=1e-3)
    ctx = SimpleNamespace(cell=SimpleNamespace(config=dict(scene=scene)),
                          jobs=[SimpleNamespace(refined=g) for g in grids])
    assert metric("surface_err_um").read(ctx) == pytest.approx(300.0, rel=1e-3)
