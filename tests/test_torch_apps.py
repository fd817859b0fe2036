"""The port's three command-line apps against the JAX package's on the CPU.

One module-scoped run: the golden sphere (`GoldenSceneSpec()`: 12 frames at
160×120, 1 cm → 5 mm over 2 grid and 2 pyramid levels, poses free; one
outer iteration a level instead of its 3, which keeps the file near 2.5
minutes on one worker, most of it the JAX refinement's compiles) is
exported once and copied into three folders. The JAX apps run in the first,
the port's apps (`main(argv, device="cpu")`) in the second, and the port's
refinement app in the third on the JAX-written `.tsdf` and `keyframes.txt`.

Tolerances, each measured on this scene (`python tests/torch_parity_report.py
apps --iterations 1`; the 3-iteration and noise figures with
`--iterations 3 --noise 1e-7 1e-6`) and stated with its reason:
- `keyframes.txt`: the header and every selection flag identical; the blur
  scores within 1e-5 (measured 2.0e-6). The files are not byte-identical:
  XLA's CPU reduction sums the 19,040 float32 pixel differences of a frame
  with an error of 2.5e-6 relative (against a float64 sum), torch's with
  9.1e-8 (`python tests/torch_parity_report.py blur`), and the printed
  scores have six decimals;
- `.tsdf`: identical voxel coordinates; sdf atol 1e-6 m (measured 7.5e-9)
  and weights rtol 1e-6 (weights up to 29; measured 6.4e-7 relative,
  float32 sums in another order); colors within one uint8 step (a float
  color at an integer boundary);
- the fused PLY: the same faces, vertices atol 1e-6 m (measured 7.5e-9);
- per level: the same file names; intrinsics byte-identical (fixed by the
  golden yml); keyframe poses within 0.02 m and 0.05 in every rotation
  matrix entry of the live JAX run (measured 4.4e-3 to 4.6e-3 m and 1.1e-2
  at the finest level over two runs; 4.3e-3 m and 1.1e-2 for the run from
  JAX's files). The
  final poses grow chaotic with more iterations in the reference itself:
  at the scene's 3 iterations a level the port lands 0.0215 m from JAX,
  and 1e-7 noise on the color images moves JAX's own final keyframe
  centres by up to 0.018 m. They are not compared with the committed
  goldens (ROADMAP §3);
- refined meshes: symmetric chamfer mean under 0.05 voxel (measured
  4.4e-6 m = 9e-4 voxel at the finest 5 mm);
- the port's refined keyframe centres within 0.2 m of the analytic orbit
  (the JAX golden test's bar; measured 0.027 m, JAX 0.030 m).
"""

import dataclasses
import os
import shutil

import jax  # noqa: F401  (imported before the JAX package's modules)
import numpy as np
import pytest
import torch

from intrinsic3d_tpu.apps import app_fusion as j_app_fusion
from intrinsic3d_tpu.apps import app_intrinsic3d as j_app_intrinsic3d
from intrinsic3d_tpu.apps import app_keyframes as j_app_keyframes

from intrinsic3d_torch.apps import app_fusion, app_intrinsic3d, app_keyframes
from intrinsic3d_torch.io.golden_dataset import GoldenSceneSpec, export_sphere_dataset
from intrinsic3d_torch.io.ply import load_ply
from intrinsic3d_torch.io.trajectory import load_poses
from intrinsic3d_torch.io.tsdf_io import load_tsdf
from intrinsic3d_torch.mesh.metrics import chamfer_distance

STAGES = (("keyframes", "keyframes.yml"), ("fusion", "fusion.yml"), ("intrinsic3d", "intrinsic3d.yml"))
LEVELS = ("g1_p1", "g1_p0", "g0_p0")
SPEC = dataclasses.replace(GoldenSceneSpec(), iterations=1)


def _run(main, root, cfg, **kw):
    cwd = os.getcwd()
    try:
        assert main(["-s", os.path.join(root, "sensor.yml"), "-c", os.path.join(root, cfg)], **kw) == 0
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        base = tmp_path_factory.mktemp("apps")
        src = str(base / "dataset")
        export_sphere_dataset(src, SPEC)
        roots = {name: str(base / name) for name in ("jax", "port", "cross")}
        for r in roots.values():
            shutil.copytree(src, r)
        jax_apps = dict(keyframes=j_app_keyframes, fusion=j_app_fusion, intrinsic3d=j_app_intrinsic3d)
        port_apps = dict(keyframes=app_keyframes, fusion=app_fusion, intrinsic3d=app_intrinsic3d)
        for stage, cfg in STAGES:
            _run(jax_apps[stage].main, roots["jax"], cfg)
        for stage, cfg in STAGES:
            _run(port_apps[stage].main, roots["port"], cfg, device="cpu")
        os.makedirs(os.path.join(roots["cross"], "fusion"))
        for rel in ("fusion/keyframes.txt", "fusion/volume.tsdf"):
            shutil.copyfile(os.path.join(roots["jax"], rel), os.path.join(roots["cross"], rel))
        _run(app_intrinsic3d.main, roots["cross"], "intrinsic3d.yml", device="cpu")
    finally:
        torch.set_num_threads(n)
    return roots


def _read(root, rel, mode="r"):
    with open(os.path.join(root, rel), mode) as f:
        return f.read()


def test_keyframes_match_jax(runs):
    got = _read(runs["port"], "fusion/keyframes.txt").splitlines()
    want = _read(runs["jax"], "fusion/keyframes.txt").splitlines()
    assert got[0] == want[0] == "3"
    assert len(got) == len(want) == 1 + SPEC.num_frames
    for lg, lw in zip(got[1:], want[1:]):
        (sg, fg), (sw, fw) = lg.split(), lw.split()
        assert fg == fw
        assert abs(float(sg) - float(sw)) < 1e-5
    assert sum(int(line.split()[1]) for line in got[1:]) == 4


def test_tsdf_matches_jax(runs):
    got = load_tsdf(os.path.join(runs["port"], "fusion/volume.tsdf"))
    want = load_tsdf(os.path.join(runs["jax"], "fusion/volume.tsdf"))
    assert not got.is_sbr and got.num_voxels == want.num_voxels > 10000
    assert (got.voxel_size, got.truncation, got.integration_weight_sample) == (
        want.voxel_size, want.truncation, want.integration_weight_sample)
    np.testing.assert_array_equal(got.coords, want.coords)
    np.testing.assert_allclose(got.sdf, want.sdf, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.weight, want.weight, rtol=1e-6, atol=0)
    assert np.abs(got.color.astype(int) - want.color.astype(int)).max() <= 1


def test_fused_mesh_matches_jax(runs):
    v, f, c = load_ply(os.path.join(runs["port"], "fusion/mesh.ply"))
    jv, jf, jc = load_ply(os.path.join(runs["jax"], "fusion/mesh.ply"))
    assert len(f) == len(jf) > 1000
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, rtol=0, atol=1e-6)
    assert np.abs(c.astype(int) - jc.astype(int)).max() <= 1


def _level_files(root):
    return sorted(os.listdir(os.path.join(root, "intrinsic3d")))


def test_same_per_level_files(runs):
    want = sorted(f"{kind}_{lvl}{ext}" for lvl in LEVELS for kind, ext in
                  (("mesh", ".ply"), ("mesh", "_albedo.ply"), ("poses", ".txt"), ("intrinsics", ".txt")))
    assert _level_files(runs["port"]) == _level_files(runs["jax"]) == _level_files(runs["cross"]) == want
    for lvl in LEVELS:
        rel = f"intrinsic3d/intrinsics_{lvl}.txt"
        assert _read(runs["port"], rel) == _read(runs["jax"], rel) == _read(runs["cross"], rel)


def _keyframe_poses(root, lvl):
    poses, ts = load_poses(os.path.join(root, f"intrinsic3d/poses_{lvl}.txt"))
    assert ts == [float(i) for i in range(SPEC.num_frames)]
    return np.stack(poses)


@pytest.mark.parametrize("other", ["port", "cross"])
def test_poses_match_the_live_jax_run(runs, other):
    kf = [int(line.split()[1]) for line in _read(runs["jax"], "fusion/keyframes.txt").splitlines()[1:]]
    for lvl in LEVELS:
        got, want = _keyframe_poses(runs[other], lvl), _keyframe_poses(runs["jax"], lvl)
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got[:, :3, 3], want[:, :3, 3], rtol=0, atol=0.02, err_msg=lvl)
        np.testing.assert_allclose(got[:, :3, :3], want[:, :3, :3], rtol=0, atol=0.05, err_msg=lvl)
        # frames that are not keyframes keep the dataset's poses (to the
        # file's six decimals)
        still = ~np.asarray(kf, bool)
        np.testing.assert_allclose(got[still], want[still], rtol=0, atol=2e-6)


def test_port_poses_within_the_orbit_bound(runs):
    root = runs["port"]
    poses = _keyframe_poses(root, "g0_p0")
    errs = [np.linalg.norm(T[:3, 3] - np.loadtxt(os.path.join(root, "rgbd", f"frame-{i:06d}.pose.txt"))[:3, 3])
            for i, T in enumerate(poses)]
    assert max(errs) < 0.2, np.round(errs, 4)


@pytest.mark.parametrize("other", ["port", "cross"])
@pytest.mark.parametrize("lvl", LEVELS)
def test_refined_meshes_match_jax(runs, other, lvl):
    voxel = {"g1": 0.01, "g0": 0.005}[lvl[:2]]
    for suffix in ("", "_albedo"):
        rel = f"intrinsic3d/mesh_{lvl}{suffix}.ply"
        v, f, c = load_ply(os.path.join(runs[other], rel))
        jv, jf, _ = load_ply(os.path.join(runs["jax"], rel))
        assert len(f) > 1000 and np.all(np.isfinite(v)) and c is not None
        assert abs(len(f) - len(jf)) <= 0.01 * len(jf)
        ch = chamfer_distance(v, f, jv, jf, num_samples=5000)
        assert ch["symmetric_mean"] < 0.05 * voxel, (rel, ch)


@pytest.mark.parametrize("stage", [s for s, _ in STAGES])
def test_apps_default_to_the_card(runs, stage, monkeypatch):
    """Called without `device=`, each app asks for CUDA and raises when
    there is none — never a silent CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = dict(keyframes=app_keyframes, fusion=app_fusion, intrinsic3d=app_intrinsic3d)[stage].main
    with pytest.raises(RuntimeError, match="CUDA"):
        _run(main, runs["port"], dict(STAGES)[stage])
