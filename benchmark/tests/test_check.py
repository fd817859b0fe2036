"""The whole run on the CPU at the tiny size: a sound run is correct and
reports its metrics; the control (the reference in bfloat16 in the
program's place) is not correct."""

import pytest

from benchmark import check, control, run
from benchmark.tests.conftest import TINY_LIMITS

SEED = 2**31 + 11


def test_sound_run_is_correct_and_reports_its_end_to_end_metrics(tiny_root):
    res = run.execute("tiny.reconstruct", SEED, 0.0, False, device="cpu", root=tiny_root)
    assert res["correct"] and res["attempted"] == 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"reconstruct_s", "surface_err_um", "setup_s"}
    assert list(res)[-1] == "checks" and set(res["checks"]) == set(check.NUMBERS)
    for k in ("cost_start_gap", "cost_end_gap", "svsh_gap", "fusion_gap", "transition_gap", "kf_score_gap"):
        assert res["checks"][k]["value"] < 1e-4, (k, res["checks"][k])


def test_traced_export_run_reports_its_per_layer_metrics(tiny_root):
    res = run.execute("tiny.export", SEED, 0.0, True, device="cpu", root=tiny_root)
    assert res["correct"], res["checks"]
    assert set(check.MESH_NUMBERS) <= set(res["checks"])
    # no device on the CPU: the device readers find nothing to read
    assert {"keyframes_fusion_s", "levels.host_s", "solve.finest_s", "solve.coarse_s", "exports_s"} == set(
        res["metrics"])
    assert res["device"]["window_s"] > 0 and len(res["breakdown"]["idle_gaps"]) >= 1


@pytest.mark.parametrize("workload", ["tiny.reconstruct", "tiny.export"])
def test_the_control_is_not_correct(tiny_root, workload):
    (r,) = control.readings(workload, [SEED + 1], device="cpu", root=tiny_root)
    sound = check.judge(r["sound"], TINY_LIMITS)
    ctl = check.judge(r["control"], TINY_LIMITS)
    assert all(ok for _, _, ok in sound.values()), sound
    failed = {k for k, (_, _, ok) in ctl.items() if not ok}
    # every gap the bfloat16 arithmetic reaches is outside its limit
    assert failed >= {"kf_score_gap", "fusion_gap", "fusion_voxel_mismatch", "svsh_gap", "cost_start_gap",
                      "cost_end_gap", "recolor_gap", "transition_gap"}, ctl
    if workload == "tiny.export":
        assert {"mesh_vertex_gap", "mesh_missing_share"} <= failed
