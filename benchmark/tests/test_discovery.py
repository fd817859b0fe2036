"""Cells, configurations, traffic mixes and metrics are found by name: a
new one is files and BENCHMARK.json entries, with no edit to a file the
benchmark has."""

import json
import shutil

import pytest

from benchmark import harness, run

# a job kind that needs code: keyframes and fusion only, as a capture
# session that fuses a long stream and refines nothing would run
CAPTURE_KIND = """from benchmark import harness


def run_job(kind, cell, cap, dev, rec, traced, scratch, index):
    job = harness.begin_job(cap, rec, traced)
    with harness.spans(traced)("job"):
        harness.keyframes_and_fusion(cell, cap.sensor, dev, job, traced)
    return harness.end_job(job, rec, dev)
"""


def test_added_files_are_listed_and_loaded(tmp_path):
    from benchmark.tests.conftest import REPO

    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}

    cfg = json.loads((tmp_path / "benchmark/configs/orbit10kf.json").read_text())
    cfg["name"] = "throwaway"
    (tmp_path / "benchmark/configs/throwaway.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark/traffic/burst.json").write_text(json.dumps({"name": "burst", "job": "test"}))
    (tmp_path / "benchmark/metrics/jobs_n.py").write_text("def read(ctx):\n    return len(ctx.jobs)\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="throwaway", file="benchmark/configs/throwaway.json"))
    b["workloads"].append(dict(name="throwaway.burst", config="throwaway", traffic="burst", chips=1, why="t"))
    b["per_layer"].append(dict(name="jobs_n", unit="count", better="lower", source="host_clock", layer="device",
                               moves="reconstruct_s", workloads=["throwaway.burst"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    cell = harness.load_cell("throwaway.burst", tmp_path)
    assert cell.config["name"] == "throwaway" and cell.traffic["name"] == "burst"
    assert [m["name"] for m in cell.per_layer][-1] == "jobs_n"
    assert "exports_s" not in [m["name"] for m in cell.per_layer]
    assert harness.load_metric("jobs_n", tmp_path).read(type("C", (), {"jobs": [1, 2, 3]})) == 3
    assert {m["name"] for m in harness.load_cell("orbit10kf.reconstruct", tmp_path).per_layer} == {
        m["name"] for m in b["per_layer"] if "workloads" not in m}
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_every_metric_and_cell_has_its_files():
    from benchmark.tests.conftest import REPO

    b = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in b["end_to_end"] + b["per_layer"]:
        assert hasattr(harness.load_metric(m["name"]), "read"), m["name"]
    for w in b["workloads"]:
        cell = harness.load_cell(w["name"])
        assert set(cell.config["limits"]) >= {"kf_score_gap", "cost_end_gap", "refine_gain"}
    for c in b["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert set(cfg["reduced"]) <= set(cfg["upstream"])


@pytest.mark.parametrize("by_code", [True, False], ids=["kind_in_code", "kind_in_data"])
def test_a_job_kind_in_a_traffic_file_runs_without_an_edit(tmp_path, by_code):
    from benchmark.tests.conftest import make_root

    root = make_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}

    mix = {"name": "capture", "job": "keyframes, fusion"}
    if by_code:
        (root / "benchmark/traffic/capture.py").write_text(CAPTURE_KIND)
    else:
        mix["refine"] = False
    (root / "benchmark/traffic/capture.json").write_text(json.dumps(mix))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append(dict(name="tiny.capture", config="tiny", traffic="capture", chips=1, why="t"))
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    res = run.execute("tiny.capture", 2**31 + 17, 0.0, False, device="cpu", root=root)
    # the checks follow the stages the job ran: keyframes and fusion only
    assert res["correct"] and res["attempted"] == 1, res["checks"]
    assert set(res["checks"]) == {"kf_score_gap", "kf_id_mismatch", "fusion_voxel_mismatch", "fusion_gap"}
    # the surface reader finds no refined grid and leaves its metric out
    assert set(res["metrics"]) == {"reconstruct_s", "setup_s"}
    assert {p: p.read_bytes() for p in before} == before
