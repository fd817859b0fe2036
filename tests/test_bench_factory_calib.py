"""The benchmark's refinement from a factory calibration
(`benchmark/traffic/factory-calib.py`, `benchmark/reference/camera.py`) on
the CPU at the tiny size of `benchmark/tests/conftest.py`: the capture
handed to the port through the configuration's factory camera, the
intrinsics and distortion refined with the poses.

A sound run is correct and every job ends with its intrinsics moved; the
bfloat16 control is not correct; four planted faults are each caught: a
recorded closing intrinsic off by half a pixel, a port that holds the
camera (`fix_intrinsics`, `fix_distortion` forced to 1), a last outer step
read at the level's start camera, and a camera that runs away. All but the
held camera are planted in the sound run's kept jobs, so one more run is
paid, for the held camera.
`reference/camera.py` equals `energy.assemble` where the trial camera is
the linearization's own. ~30 s on one worker.
"""

import copy
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import check, harness, run
from benchmark.reference import camera, energy, svsh
from benchmark.reference.common import thin_shell
from benchmark.tests.conftest import REPO, TINY_LIMITS, make_root, tiny_config

from torch_support import one_torch_thread  # noqa: F401

SEED = 2**31 + 101
CELL, HELD = "tinyglobals.factory-calib", "tinyheld.factory-calib"
# the tiny cell's limits: `benchmark/tests/conftest.py`'s, the 9 camera
# coefficients a sound job moves (a held camera reads 9), and how far it
# moves the camera over the object (a sound job 1.28 px, the planted
# runaway 6.48 px on this capture's 128-pixel-wide frames)
LIMITS = dict(TINY_LIMITS, globals_unmoved=0.5, camera_moved_px=3.0)
GLOBALS_METRICS = ("solve.globals_s", "solve.lm_tries")


def _config(name: str, held: bool) -> dict:
    cfg = tiny_config()
    cfg["name"] = name
    cfg["intrinsic3d"].update(fix_intrinsics=int(held), fix_distortion=int(held))
    cfg["factory_camera"] = json.loads((REPO / "benchmark/configs/orbit10kf-globals.json").read_text())[
        "factory_camera"]
    cfg["limits"] = dict(LIMITS)
    return cfg


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny benchmark with a factory-calibration cell on the tiny
    configuration, and one whose camera the port holds."""
    path = make_root(tmp_path_factory.mktemp("factory"))
    b = json.loads((path / "BENCHMARK.json").read_text())
    for cell, held in ((CELL, False), (HELD, True)):
        name = cell.split(".")[0]
        (path / f"benchmark/configs/{name}.json").write_text(json.dumps(_config(name, held)))
        b["configs"].append(dict(b["configs"][0], name=name, file=f"benchmark/configs/{name}.json"))
        b["workloads"].append(dict(name=cell, config=name, traffic="factory-calib", chips=1, why="tests"))
    for m in b["per_layer"]:
        if m["name"] in GLOBALS_METRICS:
            m["workloads"].append(CELL)
    (path / "BENCHMARK.json").write_text(json.dumps(b))
    return path


def _run(root, workload, traced=False):
    """`run.execute` on the CPU; returns (result, [(job, frames, cell)] the
    check read)."""
    kept = []
    load = harness.load_cell

    def load_cell(name, root=harness.ROOT):
        cell = load(name, root)
        readings = cell.kind.readings

        def keeping(job, frames, cell, **kw):
            kept.append((job, frames, cell))
            return readings(job, frames, cell, **kw)

        cell.kind.readings = keeping
        return cell

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "load_cell", load_cell)
        res = run.execute(workload, SEED, 0.0, traced, device="cpu", root=root)
    return res, kept


@pytest.fixture(scope="module")
def sound(root):
    """The sound run, traced: its result and the jobs the check read."""
    return _run(root, CELL, traced=True)


def _failed(readings: dict) -> set:
    return {k for k, (_, _, ok) in check.judge(readings, LIMITS).items() if not ok}


def test_sound_run_is_correct_and_every_job_moves_the_camera(sound):
    res, kept = sound
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["checks"]["globals_unmoved"]["value"] == 0.0
    assert set(res["checks"]) == set(check.NUMBERS) | {"globals_unmoved", "camera_moved_px"}
    assert len(kept) == res["attempted"] >= 1
    for job, _, _ in kept:
        intr0 = job.levels[0]["start"]["intr"]
        intr1, dist1 = (torch.as_tensor(a) for a in job.camera)
        assert bool(torch.isfinite(intr1).all()) and bool(torch.isfinite(dist1).all())
        assert bool((intr1 != intr0).all()), (intr1, intr0)
        # every level's closing camera is finite and the next level starts from it
        for lv, nxt in zip(job.levels, job.levels[1:] + [None]):
            assert all(bool(torch.isfinite(lv["end"][k]).all()) for k in ("intr", "dist"))
            if nxt is not None:
                assert all(torch.equal(nxt["start"][k], lv["end"][k]) for k in ("intr", "dist"))


def test_the_traced_run_reads_the_global_block_and_the_lm_tries(sound):
    res, kept = sound
    got = res["metrics"]
    assert got["solve.globals_s"]["value"] > 0 and got["solve.globals_s"]["unit"] == "s"
    tries = sum(sum(lv["stats"].tries) for lv in kept[0][0].levels)
    assert got["solve.lm_tries"] == {"value": float(tries), "unit": "count"}
    # at least one try an outer step
    assert tries >= sum(len(lv["stats"].tries) for lv in kept[0][0].levels) > 0


def test_globals_and_lm_tries_readers_on_hand_made_events():
    host = [(0.0, 10.0, "job"), (1.0, 2.0, "solve.globals"), (1.5, 2.5, "solve.globals"), (3.0, 3.5, "solve.lm_try"),
            (10.0, 20.0, "job"), (12.0, 12.5, "solve.globals")]
    ctx = SimpleNamespace(host=host, jobs=[1, 2])
    # the union: [1, 2.5] and [12, 12.5], two jobs
    assert harness.load_metric("solve.globals_s").read(ctx) == pytest.approx(1.0)
    assert harness.load_metric("solve.globals_s").read(SimpleNamespace(host=host[3:5], jobs=[1])) is None

    def job(*tries):
        return SimpleNamespace(levels=[dict(stats=SimpleNamespace(tries=list(t))) for t in tries])

    lm = harness.load_metric("solve.lm_tries")
    assert lm.read(SimpleNamespace(jobs=[job([1, 1, 5], [2]), job([1, 1])])) == 5.5  # (9 + 2) / 2
    # a program without the count, and a job without levels: nothing to read
    assert lm.read(SimpleNamespace(jobs=[SimpleNamespace(levels=[dict(stats=SimpleNamespace())])])) is None
    assert lm.read(SimpleNamespace(jobs=[SimpleNamespace(levels=[])])) is None


def test_the_bfloat16_control_is_not_correct(sound):
    _, kept = sound
    job, frames, cell = kept[0]
    failed = _failed(cell.kind.readings(job, frames, cell, control=True))
    assert failed >= {"kf_score_gap", "fusion_gap", "fusion_voxel_mismatch", "svsh_gap", "cost_start_gap",
                      "cost_end_gap", "recolor_gap", "transition_gap"}, failed
    # the control reads the program's own refined state for these three
    assert not failed & {"refine_gain", "globals_unmoved", "camera_moved_px"}


def _edited(job, edit):
    """A copy of `job` with copies of its level records that `edit(copy)`
    changed (the kept job's own records untouched)."""
    levels = []
    for lv in job.levels:
        lv = dict(lv, start=dict(lv["start"]), end=dict(lv["end"]))
        if lv.get("last_step") is not None:
            lv["last_step"] = dict(lv["last_step"])
        levels.append(lv)
    out = copy.copy(job)
    out.levels = levels
    edit(out)
    return out


def _closing_intrinsic_shifted(job):
    job.levels[0]["end"]["intr"] = job.levels[0]["end"]["intr"] + torch.tensor([0.0, 0.0, 0.5, 0.0])


def _last_step_at_start_camera(job):
    for lv in job.levels:
        kept = lv["last_step"]
        kept["params"] = kept["params"]._replace(intr=lv["start"]["intr"], dist=lv["start"]["dist"])


def _camera_run_away(job):
    # the refined camera of the whole global block's exact elimination on
    # the full-size cell: focal lengths from 591.7 to 966 and 953, a strong
    # radial lens
    intr, _ = job.camera
    job.camera = (intr * np.array([1.632, 1.611, 1.0, 1.0], np.float32),
                  np.array([-1.965, -51.04, 139.9, -0.048, 0.044], np.float32))


@pytest.mark.parametrize("fault,caught_by", [
    (_closing_intrinsic_shifted, "transition_gap"),
    (None, "globals_unmoved"),
    (_last_step_at_start_camera, "cost_end_gap"),
    (_camera_run_away, "camera_moved_px"),
], ids=["closing_intrinsic_shifted", "camera_held", "last_step_at_start_camera", "camera_run_away"])
def test_a_planted_fault_is_caught(root, sound, fault, caught_by):
    if fault is None:
        # a port that holds the camera: every gap follows it and passes
        res, _ = _run(root, HELD)
        assert not res["correct"]
        assert res["checks"]["globals_unmoved"]["value"] == 9.0
        assert {k for k, c in res["checks"].items() if c["value"] > c["limit"]} == {"globals_unmoved"}
        return
    job, frames, cell = sound[1][0]
    r = cell.kind.readings(_edited(job, fault), frames, cell)
    assert caught_by in _failed(r), r


def test_camera_reference_is_energy_at_the_linearization_camera(sound):
    """`camera.assemble` with the trial camera the linearization's own is
    `energy.assemble`, bit for bit; with the level's closing camera only
    its E_g row differs."""
    job, frames, cell = sound[1][0]
    r3 = cell.config["intrinsic3d"]
    lv_rec = job.levels[0]
    st, en = lv_rec["start"], lv_rec["end"]
    dev, f64 = frames.dev, torch.float64

    def level(src):
        return energy.Level(st["coords"], st["voxel"], st["sdf"], st["weight"], st["color"], src["sdf_refined"],
                            src["albedo"], f64, dev)

    l0, l1 = level(st), level(en)
    thres = thin_shell(r3, int(lv_rec["grid_level"]), float(st["voxel"]))
    sh = svsh.voxel_sh(l0, thres, float(r3["subvolume_size_sh"]), float(r3["subvolume_sh_lamda_reg"]))
    _, ids = frames.reference_keyframes(cell.config)
    img, dep = frames.keyframes(ids, int(r3["num_rgbd_levels"]), f64)[int(lv_rec["rgbd"])]
    cam0 = (st["intr"].to(f64), st["dist"].to(f64))
    args = (st["poses"].to(f64), *cam0, sh, img, dep, thres, float(r3["occlusion_distance"]),
            int(r3["num_observations"]), 1.0 / 2 ** int(lv_rec["rgbd"]))
    trial = (l1.sdfr, l1.albedo, en["poses"].to(f64))
    want = energy.assemble(l0, *args, at=trial)
    assert torch.equal(camera.assemble(l0, *args, at=trial + cam0), want)
    moved = camera.assemble(l0, *args, at=trial + (en["intr"].to(f64), en["dist"].to(f64)))
    assert torch.equal(moved[1:], want[1:]) and moved[0, 1] == want[0, 1]
    assert abs(float(moved[0, 0]) - float(want[0, 0])) > 1e-6 * float(want[0, 0])
