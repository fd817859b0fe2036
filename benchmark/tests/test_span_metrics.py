"""The readers of the program's spans and host-read counter
(`solve.host_reads`, `solve.idle_pct`, `levels.idle_s`,
`levels.join_wait_s`) on hand-made events, and in a traced tiny run on the
CPU."""

import json
from types import SimpleNamespace

import pytest

from benchmark import harness, run
from benchmark.tests.conftest import make_root

SEED = 2**31 + 29
NEW = ("solve.host_reads", "solve.idle_pct", "levels.idle_s", "levels.join_wait_s")


def metric(name):
    return harness.load_metric(name)


def _job(*reads):
    return SimpleNamespace(levels=[dict(stats=SimpleNamespace(host_reads=n)) for n in reads])


def test_host_reads_sum_the_levels_and_average_the_jobs():
    ctx = SimpleNamespace(jobs=[_job(100, 20, 3), _job(90, 10)])
    assert metric("solve.host_reads").read(ctx) == 111.5
    # a program without the counter, and a job without levels: nothing to read
    bare = SimpleNamespace(levels=[dict(stats=SimpleNamespace())])
    assert metric("solve.host_reads").read(SimpleNamespace(jobs=[bare])) is None
    assert metric("solve.host_reads").read(SimpleNamespace(jobs=[SimpleNamespace(levels=[])])) is None


# two jobs on one timeline: each a `refine` mark holding two solves, the second
# solve of job 1 with a nested child; device work leaves gaps at either end of
# each solve and between the solves
HOST = [
    (0.0, 10.0, "job"), (1.0, 10.0, "refine"),
    (2.0, 4.0, "solve[p1v10]"), (2.5, 3.0, "solve.lm_try"), (5.0, 8.0, "solve[p0v80]"),
    (6.0, 7.0, "solve.assemble"), (4.2, 4.7, "join[i3d-prep:level p0v80]"),
    (10.0, 20.0, "job"), (11.0, 20.0, "refine"),
    (12.0, 14.0, "solve[p1v10]"), (15.0, 18.0, "solve[p0v80]"), (14.5, 15.0, "join[i3d-prep:level p0v80]"),
    (14.8, 14.9, "join[i3d-prep:upsample v10]"), (16.0, 16.5, "aten::add"),
]
DEVICE = [(0.5, 2.5, "k"), (3.0, 3.5, "k"), (6.0, 7.5, "k"), (9.0, 9.5, "k"),
          (12.5, 13.5, "k"), (15.0, 17.0, "k"), (19.0, 21.0, "k")]


def _ctx(**kw):
    base = dict(host=HOST, device=DEVICE, jobs=[1, 2], traced=(0.0, 20.0))
    base.update(kw)
    return SimpleNamespace(**base)


def test_solve_idle_share_counts_the_gaps_at_either_end():
    # solves 10 s, busy 0.5 + 0.5 + 1.5 + 1 + 2 = 5.5 s
    assert metric("solve.idle_pct").read(_ctx()) == pytest.approx(45.0)
    nested = _ctx(host=HOST + [(2.0, 3.0, "solve[p1v10]")])  # an overlapping range counts once
    assert metric("solve.idle_pct").read(nested) == pytest.approx(45.0)
    assert metric("solve.idle_pct").read(_ctx(device=[])) is None
    assert metric("solve.idle_pct").read(_ctx(host=[h for h in HOST if not h[2].startswith("solve[")])) is None


def test_level_stages_idle_is_the_refine_marks_less_the_solves():
    # inside `refine`, outside the solves: [1, 2] [4, 5] [8, 10] and [11, 12]
    # [14, 15] [18, 20], 8 s; busy there 1 + 0.5 + 1 s
    assert metric("levels.idle_s").read(_ctx()) == pytest.approx(5.5 / 2)
    assert metric("levels.idle_s").read(_ctx(device=[])) is None
    assert metric("levels.idle_s").read(_ctx(host=[h for h in HOST if not h[2].startswith("solve[")])) is None
    # the three parts of the window's idle time add up to the device's idle share
    lo, hi = 0.0, 20.0
    in_solves = metric("solve.idle_pct").read(_ctx()) / 100.0 * 10.0
    outside_refine = 0.5 + 1.0  # [0, 1] less the device's [0.5, 1], and [10, 11]
    total = metric("device.idle_pct").read(_ctx()) / 100.0 * (hi - lo)
    assert metric("levels.idle_s").read(_ctx()) * 2 + in_solves + outside_refine == pytest.approx(total)


def test_join_wait_is_the_union_of_the_join_ranges_a_job():
    assert metric("levels.join_wait_s").read(_ctx(device=[])) == pytest.approx((0.5 + 0.5) / 2)
    assert metric("levels.join_wait_s").read(_ctx(host=HOST[:6])) is None
    assert metric("levels.join_wait_s").read(_ctx(host=None)) is None


@pytest.fixture(scope="module")
def traced_root(tmp_path_factory):
    """The tiny root with the new readers applied to its reconstruct cell."""
    root = make_root(tmp_path_factory.mktemp("spans"))
    b = json.loads((root / "BENCHMARK.json").read_text())
    for m in b["per_layer"]:
        if m["name"] in NEW:
            m["workloads"].append("tiny.reconstruct")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root


def test_a_traced_tiny_run_reads_the_counter_and_the_joins(traced_root):
    res = run.execute("tiny.reconstruct", SEED, 0.0, True, device="cpu", root=traced_root)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert got["solve.host_reads"]["value"] > 0 and got["solve.host_reads"]["unit"] == "count"
    assert got["levels.join_wait_s"]["value"] > 0
    # no device on the CPU: the device-based readers find nothing to read
    assert "solve.idle_pct" not in got and "levels.idle_s" not in got
    # the window's gaps are named by the program's spans where one covers them
    names = [name for name, _ in res["breakdown"]["idle_gaps"]]
    assert any(n.startswith("refine: ") and n != "refine: no torch op" for n in names)
