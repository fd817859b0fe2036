"""A small copy of the benchmark for the CPU tests: the repository's
BENCHMARK.json and benchmark/ in a temporary root, plus a tiny
configuration (12 frames at 128x96, 1 cm voxels, 2 grid and 2 pyramid
levels, 3 iterations) with cells on both traffic mixes."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]

# limits of the tiny configuration, from its CPU readings: the port's gaps
# against the float64 reference read 1e-7..5e-5, the bfloat16 control
# 4e-4..12, `refine_gain` 0.51..0.72 and 1 for a level loop that leaves its
# state unchanged
TINY_LIMITS = dict(kf_score_gap=1e-4, kf_id_mismatch=0.0, fusion_voxel_mismatch=1e-4, fusion_gap=1e-3,
                   transition_voxel_mismatch=1e-4, transition_gap=1e-3, svsh_gap=1e-3, cost_start_gap=1e-3,
                   cost_end_gap=1e-3, recolor_gap=1e-2, refine_gain=0.9, mesh_vertex_gap=1e-3,
                   mesh_missing_share=0.05)


def tiny_config() -> dict:
    cfg = json.loads((REPO / "benchmark/configs/orbit10kf.json").read_text())
    cfg["name"] = "tiny"
    # 12 views 30 degrees apart: turned by a third of a step, so that no view
    # looks along an axis (at 128x96 such views put voxel columns exactly on
    # half-pixel boundaries, where float32 and float64 round apart)
    cfg["scene"].update(frames=12, width=128, height=96, phase=0.37)
    cfg["fusion"]["voxel_size"] = 0.01
    cfg["intrinsic3d"].update(num_grid_levels=2, num_rgbd_levels=2, iterations=3, lm_steps=8)
    cfg["limits"] = dict(TINY_LIMITS)
    return cfg


def make_root(path: Path) -> Path:
    shutil.copytree(REPO / "benchmark", path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (path / "benchmark/configs/tiny.json").write_text(json.dumps(tiny_config()))
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="tiny", file="benchmark/configs/tiny.json"))
    b["workloads"] += [dict(name="tiny.reconstruct", config="tiny", traffic="reconstruct", chips=1, why="tests"),
                       dict(name="tiny.export", config="tiny", traffic="export", chips=1, why="tests")]
    # the exports' reader, which no cell of the benchmark names yet: on the card the export cell's
    # runs spread too widely for a bound
    b["per_layer"].append(dict(name="exports_s", unit="s", better="lower", source="program_span", layer="exports",
                               moves="reconstruct_s", workloads=["tiny.export"]))
    (path / "BENCHMARK.json").write_text(json.dumps(b))
    return path


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("bench"))
