"""What a run loads: no JAX and no JAX package anywhere, and nothing of the
program in the reference."""

import json
import subprocess
import sys

from benchmark.tests.conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "intrinsic3d_tpu"}


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps(sorted(sys.modules)))"],
                         cwd=REPO, capture_output=True, text=True, check=True, timeout=300)
    return {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}


def test_harness_scene_and_reference_load_no_jax():
    mods = _modules("import benchmark.run, benchmark.harness, benchmark.scene, benchmark.check, benchmark.control,"
                    " benchmark.trace\nimport intrinsic3d_torch.refine.intrinsic3d, intrinsic3d_torch.apps.app_fusion,"
                    " intrinsic3d_torch.apps.app_keyframes, intrinsic3d_torch.apps.app_intrinsic3d")
    assert "intrinsic3d_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    mods = _modules("import benchmark.reference.common, benchmark.reference.energy, benchmark.reference.fusion,"
                    " benchmark.reference.keyframes, benchmark.reference.mesh, benchmark.reference.svsh,"
                    " benchmark.reference.transition")
    assert not mods & (FORBIDDEN | {"intrinsic3d_torch"})


def test_run_refuses_without_a_card_and_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "orbit10kf.reconstruct", "--seed",
                          str(2**31 + 5), "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_fails_without_the_program(tmp_path):
    import shutil

    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "orbit10kf.reconstruct", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
