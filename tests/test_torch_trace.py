"""The refinement's spans on the profiler's timeline and the level solve's
host-read counter (`intrinsic3d_torch.timer`), on the CPU.

The end-to-end scene of the engine tests (2 grid × 2 pyramid levels) is
refined once under `torch.profiler` (CPU activity) and once without: every
phase opens a span under its `stats` name on the main thread, each child
inside its parent, no span takes a benchmark mark's name, the `stats` keys
are a pinned list (the benchmark's readers and the tools parse them), and each
level's `OptimizeStats.host_reads` is the count of scalar reads
(`aten::_local_scalar_dense`) the profile records inside its `solve[...]`
range, with and without a profiler.
"""

import inspect
import re
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.trace import MARKS
from intrinsic3d_torch import timer
from intrinsic3d_torch.apps import app_fusion
from intrinsic3d_torch.config import FusionConfig, RefinementConfig
from intrinsic3d_torch.grid import algorithms as alg
from intrinsic3d_torch.prefetch import HostPrep
from intrinsic3d_torch.refine import intrinsic3d as engine_mod
from intrinsic3d_torch.refine import mesh_pipeline
from intrinsic3d_torch.refine.intrinsic3d import Intrinsic3D
from intrinsic3d_torch.refine.optimizer import LevelPrep
from intrinsic3d_torch.synthetic import (
    SMALL_CG_ITERS,
    SMALL_REFINEMENT,
    SMALL_VOXEL,
    build_sphere_problem,
    small_refinement_sensor,
)

from torch_support import one_torch_thread  # noqa: F401

# the `stats` keys of the scene's refinement, in order
STATS_KEYS = [
    "pyramids", "initial_recolor", "sparsify[g1]", "topology[g1]", "svsh[g1p1]", "prefetch[p1v2372]",
    "level_setup[p1v2372]", "solve[p1v2372]", "recolor[g1p1]", "svsh[g1p0]", "prefetch[p0v2372]",
    "level_setup[p0v2372]", "solve[p0v2372]", "recolor[g1p0]", "upsample[g1]", "upsample_prep[g1]", "sparsify[g0]",
    "topology[g0]", "svsh[g0p0]", "prefetch[p0v9276]", "level_setup[p0v9276]", "solve[p0v9276]", "recolor[g0p0]",
]
# the phases that are spans (the others are the prep threads' own seconds)
PHASES = [k for k in STATS_KEYS if not k.startswith(("prefetch[", "upsample_prep["))]
CHILDREN = {"join[": ("level_setup[", "sparsify[", "upsample["), "solve.assemble": ("solve[",),
            "solve.lm_try": ("solve[",), "solve.globals": ("solve[",), "upsample.fields": ("upsample[",),
            "level_setup.static": ("level_setup[",)}


def _events(prof):
    """(name, start ns, end ns, thread, user annotation) of every CPU event."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id(), e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()]


def _refine(fused, profiled: bool):
    stats, levels = {}, []

    def run():
        engine = Intrinsic3D(SMALL_REFINEMENT, small_refinement_sensor(), list(range(5)), cg_iters=SMALL_CG_ITERS,
                             device="cpu", stats=stats)
        engine.add_callback(lambda i: levels.append(i.stats))
        engine.refine(fused.clone(), stats=stats)

    if not profiled:
        run()
        return stats, levels, None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return stats, levels, _events(prof)


@pytest.fixture(scope="module")
def runs():
    fused = app_fusion.run(small_refinement_sensor(), FusionConfig(voxel_size=SMALL_VOXEL, discont_window_size=0),
                           device="cpu")
    return {"profiled": _refine(fused, True), "plain": _refine(fused, False)}


def _spans(events):
    return [ev for ev in events if ev[4]]


def _inside(ev, parent) -> bool:
    return ev[3] == parent[3] and parent[1] <= ev[1] and ev[2] <= parent[2]


def test_every_phase_is_a_span_and_each_child_lies_inside_its_parent(runs):
    _, _, events = runs["profiled"]
    spans = _spans(events)
    names = [s[0] for s in spans]
    assert sorted(n for n in names if n in PHASES) == sorted(PHASES)
    assert all(names.count(p) == 1 for p in PHASES)
    for child, parents in CHILDREN.items():
        kids = [s for s in spans if s[0].startswith(child)]
        assert kids, child
        for k in kids:
            assert any(_inside(k, p) for p in spans if p[0].startswith(parents)), k
    assert any(n.startswith("join[i3d-prep:level p") for n in names)
    assert any(n.startswith("join[i3d-prep:upsample v") for n in names)
    # an aten op issued inside the lighting estimate lies inside its span, on the same clock
    svsh = next(s for s in spans if s[0] == "svsh[g1p1]")
    ops = [ev for ev in events if ev[0].startswith("aten::") and ev[3] == svsh[3] and svsh[1] <= ev[1] < svsh[2]]
    assert ops and all(ev[2] <= svsh[2] for ev in ops)


def test_no_span_takes_a_mark_name_and_none_opens_off_the_main_thread(runs):
    _, _, events = runs["profiled"]
    spans = _spans(events)
    assert not {s[0] for s in spans} & set(MARKS)
    assert len({s[3] for s in spans}) == 1
    known = re.compile(r"(pyramids|initial_recolor|(sparsify|topology|upsample)\[g\d+\]|(svsh|recolor)\[g\d+p\d+\]"
                       r"|(level_setup|solve)\[p\d+v\d+\]|join\[i3d-prep:.+\]|solve\.assemble|solve\.lm_try"
                       r"|solve\.globals|upsample\.fields|level_setup\.static)$")
    assert [s[0] for s in spans if not known.match(s[0])] == []


def test_stats_keys_are_unchanged_and_every_value_a_float(runs):
    for stats, _, _ in runs.values():
        assert list(stats) == STATS_KEYS
        assert all(type(v) is float for v in stats.values())
    # no phase end synchronizes the device
    for mod in (engine_mod, mesh_pipeline):
        assert "synchronize(" not in inspect.getsource(mod)


def test_host_reads_are_the_scalar_reads_inside_each_solve(runs):
    """Every scalar read inside a level's solve is one of the counted sites:
    the PCG residual tests, the LM acceptance tests, the iteration record's
    three reads and the device assembly's occlusion test (a CPU tensor's
    `float()` is the card's device-to-host read). No constant a step."""
    _, levels, events = runs["profiled"]
    solves = [s for s in _spans(events) if s[0].startswith("solve[")]
    assert len(solves) == len(levels) == 3
    for solve, st in zip(sorted(solves, key=lambda s: s[1]), levels):
        reads = [ev for ev in events if ev[0] == "aten::_local_scalar_dense" and _inside(ev, solve)]
        steps = len(st.iter_seconds)
        assert st.host_reads == len(reads), (solve[0], st.host_reads, len(reads), steps)
        # at least the record, the occlusion test, one residual test and one acceptance a step
        assert st.host_reads >= 6 * steps


def test_counting_is_the_same_with_and_without_a_profiler(runs):
    a, b = runs["profiled"][1], runs["plain"][1]
    assert [st.host_reads for st in a] == [st.host_reads for st in b]
    assert [st.tries for st in a] == [st.tries for st in b]
    assert all(st.host_reads > 0 for st in a)


def test_join_opens_its_span_on_the_joining_thread_only(monkeypatch):
    """Every range a span opens while a profiler runs is recorded with the
    thread that opens it (the profiler records only the thread it was
    started on, so a range on a prep thread would go unseen there): a level
    prep, whose thread waits for its stencil-table thread, and an upsample
    prep, joined from a thread of the test, open `join[<prep thread>]` on
    the joining thread, and no prep thread opens one."""
    import torch.profiler as tprof

    opened = []
    real = tprof.record_function

    def recording(name, *args):
        opened.append((name, threading.current_thread().name))
        return real(name, *args)

    monkeypatch.setattr(tprof, "record_function", recording)
    tp = build_sphere_problem(voxel_size=0.015, image_size=(64, 48), num_frames=3, num_observations=2,
                              perturb_sdf=0.002, perturb_albedo=0.05, cfg=RefinementConfig(num_observations=2),
                              device="cpu")
    g = tp.grid.clone()

    def joiner():
        level = LevelPrep(tp.grid.clone(), None, tp.params, tp.cfg, tp.depths.numpy(), tp.thres_shell, 0,
                          budget=1e12)
        up = alg.UpsamplePrep(g, device="cpu")
        assert level.join().static is not None and up.join().idx is not None

    with profile(activities=[ProfilerActivity.CPU]):
        t = threading.Thread(target=joiner, name="joiner")
        t.start()
        t.join(timeout=60.0)
    assert not t.is_alive()
    prefix = HostPrep.THREAD_PREFIX
    assert opened == [(f"join[{prefix}:level p0v{tp.grid.num_voxels}]", "joiner"),
                      (f"join[{prefix}:upsample v{g.num_voxels}]", "joiner")]


def test_with_no_profiler_a_span_opens_no_range(monkeypatch):
    import torch.profiler as tprof

    opened = []
    monkeypatch.setattr(tprof, "record_function", lambda name, *args: opened.append(name))
    stats = {}
    with timer.collect(stats), timer.span("solve[p0v1]", phase=True) as s:
        pass
    assert opened == [] and stats == {"solve[p0v1]": s.seconds}
    timer.phases_reset()


def test_a_phase_span_records_its_seconds_into_the_collected_stats():
    timer.phases_reset()
    outer, inner = {}, {}
    with timer.collect(outer):
        with timer.span("a[g0]", phase=True) as a:
            with timer.span("a.child"):
                pass
        with timer.collect(inner), timer.span("b", phase=True):
            pass
        with pytest.raises(RuntimeError):
            with timer.span("c", phase=True):
                raise RuntimeError("the phase failed")
    with timer.span("d", phase=True):
        pass
    with timer.collect(None), timer.span("e", phase=True):
        pass
    assert outer == {"a[g0]": a.seconds, "b": outer["b"]} and inner == {"b": outer["b"]}
    assert a.seconds > 0.0 and all(type(v) is float for v in outer.values())
    assert [n for n, _ in timer.phases_snapshot()] == ["a[g0]", "b", "d", "e"]
    assert timer._SINKS == []
    timer.phases_reset()
