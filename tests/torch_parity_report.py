"""Parity report of the port against the JAX package on the CPU: the
measurements behind the tolerances of `test_torch_apps.py` and
`test_torch_pose_refinement.py`, printed, not asserted.

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py apps [--iterations 3] [--noise 1e-7 1e-6]
    JAX_PLATFORMS=cpu python tests/torch_parity_report.py twins
    JAX_PLATFORMS=cpu python tests/torch_parity_report.py blur
    JAX_PLATFORMS=cpu python tests/torch_parity_report.py flat

`apps` exports the golden scene (`GoldenSceneSpec()`, with `--iterations`
outer iterations a level), runs the three JAX apps and the port's apps
(`device="cpu"`) in separate folders, and prints the blur-score, `.tsdf`,
fused-mesh, per-level pose and refined-mesh differences and each side's
distance from the orbit. For each `--noise` level it then refines the
scene again with both packages' `Intrinsic3D` from the JAX-written files,
with that much uniform noise on the colour images, and prints how far the
final keyframe centres move: the reference's own rounding sensitivity.

`twins` runs the pose and distortion recoveries of
`tests/test_pose_refinement.py` for their full 12 and 40 relinearizations
through the port's block path, the JAX package's block path and the JAX
test's flat path, and prints the differences between them (and the
distortion run at 3 and 10). `blur` prints both packages' blur scores of
the golden frames against a float64 evaluation, and the float32 sums
behind their difference. `flat` evaluates the port's flat-table and block
gradients of the cost on `bench.py`'s problem in float32 and in float64
(plain versions) and prints their differences and each float32 path's error
against float64: the measurement behind `chip_smoke.py`'s gradient floor.
`twins` takes ~20 minutes; `apps` ~4 minutes at 3 iterations, plus ~3 a
noise level; `flat` ~30 s; `blur` seconds.

Like the tests, this script imports both packages; it is not collected by
pytest.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

STAGES = ("keyframes", "fusion", "intrinsic3d")


def _run_apps(apps, root, **kw):
    cwd = os.getcwd()
    for stage, app in zip(STAGES, apps):
        t0 = time.perf_counter()
        try:
            app.main(["-s", os.path.join(root, "sensor.yml"), "-c", os.path.join(root, f"{stage}.yml")], **kw)
        finally:
            os.chdir(cwd)
        print(f"  {os.path.basename(root)} app_{stage}: {time.perf_counter() - t0:.1f} s", flush=True)


def _centres(root, rel):
    from intrinsic3d_torch.io.trajectory import load_poses

    poses, _ = load_poses(os.path.join(root, rel))
    return np.stack(poses)


def _noisy(sensor, eps, seed=1):
    """`sensor` whose colour images carry uniform noise in [-eps, eps]."""
    rng = np.random.default_rng(seed)
    clean, cache = sensor.color, {}

    def color(i):
        if i not in cache:
            c = clean(i)
            cache[i] = np.clip(c + rng.uniform(-eps, eps, c.shape).astype(np.float32), 0.0, 1.0)
        return cache[i]

    sensor.color = color
    return sensor


def _refine_keyframe_poses(package, root, eps):
    """Final keyframe poses of one package's `Intrinsic3D.refine` from the
    files under `root`, with `eps` noise on the colour images."""
    cwd = os.getcwd()
    os.chdir(root)
    try:
        if package == "jax":
            from intrinsic3d_tpu.config import RefinementConfig, Settings
            from intrinsic3d_tpu.grid.voxel_grid import VoxelGrid
            from intrinsic3d_tpu.io.dataset import SensorI3D
            from intrinsic3d_tpu.keyframes import KeyframeSelection
            from intrinsic3d_tpu.refine.intrinsic3d import Intrinsic3D

            kw = {}
        else:
            from intrinsic3d_torch.config import RefinementConfig, Settings
            from intrinsic3d_torch.grid.voxel_grid import VoxelGrid
            from intrinsic3d_torch.io.dataset import SensorI3D
            from intrinsic3d_torch.keyframes import KeyframeSelection
            from intrinsic3d_torch.refine.intrinsic3d import Intrinsic3D

            kw = dict(device="cpu")
        sensor = _noisy(SensorI3D("./rgbd/"), eps) if eps else SensorI3D("./rgbd/")
        cfg = RefinementConfig.from_settings(Settings.load("intrinsic3d.yml"))
        kf = KeyframeSelection.load("fusion/keyframes.txt").keyframe_ids()
        engine = Intrinsic3D(cfg, sensor, kf, **kw)
        engine.refine(VoxelGrid.load("fusion/volume.tsdf", sensor.depth_min, sensor.depth_max))
        return np.stack([sensor.pose(i) for i in kf])
    finally:
        os.chdir(cwd)


def report_apps(iterations: int, noise) -> None:
    from intrinsic3d_tpu.apps import app_fusion as jf
    from intrinsic3d_tpu.apps import app_intrinsic3d as ji
    from intrinsic3d_tpu.apps import app_keyframes as jk

    from intrinsic3d_torch.apps import app_fusion, app_intrinsic3d, app_keyframes
    from intrinsic3d_torch.io.golden_dataset import GoldenSceneSpec, export_sphere_dataset
    from intrinsic3d_torch.io.ply import load_ply
    from intrinsic3d_torch.io.tsdf_io import load_tsdf
    from intrinsic3d_torch.mesh.metrics import chamfer_distance

    spec = dataclasses.replace(GoldenSceneSpec(), iterations=iterations)
    base = tempfile.mkdtemp(prefix="parity_apps_")
    try:
        export_sphere_dataset(os.path.join(base, "src"), spec)
        roots = {k: os.path.join(base, k) for k in ("jax", "port")}
        for r in roots.values():
            shutil.copytree(os.path.join(base, "src"), r)
        print(f"apps on GoldenSceneSpec() with {iterations} iteration(s) a level:")
        _run_apps((jk, jf, ji), roots["jax"])
        _run_apps((app_keyframes, app_fusion, app_intrinsic3d), roots["port"], device="cpu")

        def lines(r):
            with open(os.path.join(r, "fusion/keyframes.txt")) as f:
                return f.read().splitlines()

        kp, kj = lines(roots["port"]), lines(roots["jax"])
        dscore = max(abs(float(a.split()[0]) - float(b.split()[0])) for a, b in zip(kp[1:], kj[1:]))
        same_flags = [a.split()[1] for a in kp[1:]] == [b.split()[1] for b in kj[1:]]
        print(f"keyframes.txt: byte-identical {kp == kj}, flags identical {same_flags}, "
              f"largest score difference {dscore:.3e}")
        tp, tj = (load_tsdf(os.path.join(r, "fusion/volume.tsdf")) for r in (roots["port"], roots["jax"]))
        print(f".tsdf: coords equal {np.array_equal(tp.coords, tj.coords)}; sdf max diff "
              f"{np.abs(tp.sdf - tj.sdf).max():.3e} m; weight max diff {np.abs(tp.weight - tj.weight).max():.3e} "
              f"(relative {(np.abs(tp.weight - tj.weight) / np.maximum(np.abs(tj.weight), 1e-30)).max():.3e}); "
              f"colour max diff {np.abs(tp.color.astype(int) - tj.color.astype(int)).max()}")
        (vp, fp, _), (vj, fj, _) = (load_ply(os.path.join(r, "fusion/mesh.ply")) for r in (roots["port"], roots["jax"]))
        print(f"fused mesh: faces equal {np.array_equal(fp, fj)}; vertex max diff {np.abs(vp - vj).max():.3e} m")
        levels = sorted({f[len("poses_"):-4] for f in os.listdir(os.path.join(roots["jax"], "intrinsic3d"))
                         if f.startswith("poses_")}, reverse=True)
        truth = np.stack([np.loadtxt(os.path.join(roots["jax"], "rgbd", f"frame-{i:06d}.pose.txt"))
                          for i in range(spec.num_frames)])
        for lvl in levels:
            p, j = (_centres(r, f"intrinsic3d/poses_{lvl}.txt") for r in (roots["port"], roots["jax"]))
            dt = np.linalg.norm(p[:, :3, 3] - j[:, :3, 3], axis=1).max()
            dr = np.abs(p[:, :3, :3] - j[:, :3, :3]).max()
            orbit = [np.linalg.norm(x[:, :3, 3] - truth[:, :3, 3], axis=1).max() for x in (p, j)]
            (vp, fp, _), (vj, fj, _) = (load_ply(os.path.join(r, f"intrinsic3d/mesh_{lvl}.ply"))
                                        for r in (roots["port"], roots["jax"]))
            ch = chamfer_distance(vp, fp, vj, fj, num_samples=20000)["symmetric_mean"]
            print(f"level {lvl}: poses max centre diff {dt:.4e} m, max rotation entry diff {dr:.4e}; orbit error "
                  f"port {orbit[0]:.4f} m, JAX {orbit[1]:.4f} m; mesh faces {len(fp)} / {len(fj)}, symmetric "
                  f"chamfer mean {ch:.3e} m")
        for eps in noise:
            for package in ("jax", "port"):
                clean = _refine_keyframe_poses(package, roots["jax"], 0.0)
                noisy = _refine_keyframe_poses(package, roots["jax"], eps)
                shift = np.linalg.norm(clean[:, :3, 3] - noisy[:, :3, 3], axis=1)
                print(f"noise {eps:g} on the colour images: {package} final keyframe centres move by up to "
                      f"{shift.max():.4f} m (per keyframe {np.round(shift, 5).tolist()})", flush=True)
    finally:
        shutil.rmtree(base, ignore_errors=True)


def report_twins() -> None:
    import test_torch_pose_refinement as tw

    torch.set_num_threads(1)
    prob, jprob = tw._problems((False, True, True), voxel_size=0.0075, image_size=(128, 96), num_frames=3,
                               num_observations=3)
    true = prob.params.poses.numpy().copy()
    rng = np.random.default_rng(0)
    bad = true.copy()
    bad[1:, :3] += rng.normal(0, 0.05, bad[1:, :3].shape)
    bad[1:, 3:] += rng.normal(0, 0.01, bad[1:, 3:].shape)
    start = dict(poses=bad.astype(np.float32))
    port3, pcosts, mu = tw._run_port(prob, start, 3)
    flat3, fcosts, fmu = tw._run_jax(jprob, start, 3)
    print(f"pose recovery, 3 relinearizations: port - JAX flat poses {np.abs(port3.poses.numpy() - np.asarray(flat3.poses)).max():.3e}, "
          f"costs relative {np.max(np.abs(np.subtract(pcosts, fcosts)) / np.abs(fcosts)):.3e}", flush=True)
    port = tw._run_port(prob, dict(poses=port3.poses), 9, mu=mu)[0].poses.numpy()
    flat = np.asarray(tw._run_jax(jprob, dict(poses=np.asarray(flat3.poses)), 9, mu=fmu)[0].poses)
    block = np.asarray(tw._run_jax_block(jprob, start, 12)[0].poses)
    print(f"pose recovery, 12 relinearizations: port - JAX flat {np.abs(port - flat).max():.3e}, "
          f"port - JAX block {np.abs(port - block).max():.3e}, JAX block - flat {np.abs(block - flat).max():.3e}; "
          f"rotation error {np.abs(bad[1:, :3] - true[1:, :3]).mean():.4f} -> {np.abs(port[1:, :3] - true[1:, :3]).mean():.4f}",
          flush=True)

    true_dist = np.array([0.08, -0.04, 0.0, 0.10, -0.06], np.float32)
    prob, jprob = tw._problems((True, True, False), voxel_size=0.0075, image_size=(128, 96), num_frames=3,
                               num_observations=3, dist=true_dist)
    s = true_dist.copy()
    s[3:] = 0.0
    mask = np.array([0.0, 0.0, 0.0, 1.0, 1.0], np.float32)
    runs = {}
    for name, run in (("port", tw._run_port), ("JAX block", tw._run_jax_block)):
        d, mu, costs, at = s, 1e-4, [], {}
        for upto in (3, 10, 40):
            out, c, mu = run(prob if name == "port" else jprob, dict(dist=d), upto - len(costs), dist_mask=mask, mu=mu)
            d = out.dist.numpy() if name == "port" else np.asarray(out.dist)
            costs += c
            at[upto] = (d.copy(), list(costs))
        runs[name] = at
    flat = np.asarray(tw._run_jax(jprob, dict(dist=s), 40, dist_mask=mask)[0].dist)
    for upto in (3, 10, 40):
        (dp, cp), (db, cb) = runs["port"][upto], runs["JAX block"][upto]
        ratio = np.abs(dp[3:] - true_dist[3:]).mean() / np.abs(true_dist[3:]).mean()
        print(f"distortion recovery, {upto} relinearizations: port (p1, p2) {dp[3:].tolist()}, JAX block "
              f"{db[3:].tolist()}; port - JAX block {np.abs(dp - db).max():.3e}, costs relative "
              f"{np.max(np.abs(np.subtract(cp, cb)) / np.abs(cb)):.3e}; port mean error {ratio:.3f} of the start's, "
              f"last cost {cp[-1][1]:.4f} against the first {cp[0][0]:.4f}", flush=True)
    print(f"distortion recovery, 40 relinearizations of the JAX test's flat path: (p1, p2) {flat[3:].tolist()} "
          f"(true {true_dist[3:].tolist()})")


def report_blur() -> None:
    """The blur scores of the golden scene's frames by both packages against
    a float64 evaluation, and the float32 sums behind the difference."""
    import jax.numpy as jnp

    from intrinsic3d_tpu.image import blur as jblur

    from intrinsic3d_torch.color import intensity
    from intrinsic3d_torch.image import blur
    from intrinsic3d_torch.io.dataset import SensorI3D
    from intrinsic3d_torch.io.golden_dataset import GoldenSceneSpec, export_sphere_dataset

    base = tempfile.mkdtemp(prefix="parity_blur_")
    try:
        export_sphere_dataset(base, GoldenSceneSpec())
        sensor = SensorI3D(os.path.join(base, "rgbd"))
        frames = np.stack([sensor.color(i) for i in range(sensor.num_frames)])
        port = blur.blur_scores_batch(torch.as_tensor(frames)).numpy()
        ref = blur.blur_scores_batch(torch.as_tensor(frames, dtype=torch.float64)).numpy()
        jax_scores = np.asarray(jblur.blur_scores_batch(jnp.asarray(frames)))
        print(f"blur scores against float64: port {np.abs(port - ref).max():.3e}, JAX {np.abs(jax_scores - ref).max():.3e}; "
              f"port - JAX {np.abs(port - jax_scores).max():.3e}")
        gray = intensity(frames[0]).astype(np.float32)
        d = np.abs(gray[1:] - gray[:-1])
        exact = d.astype(np.float64).sum()
        print(f"sum of frame 0's {d.size} vertical differences, relative error against float64: jnp.sum "
              f"{abs(float(jnp.sum(jnp.asarray(d))) - exact) / exact:.3e}, torch.sum "
              f"{abs(float(torch.as_tensor(d).sum()) - exact) / exact:.3e}")
    finally:
        shutil.rmtree(base, ignore_errors=True)


def report_flat() -> None:
    from intrinsic3d_torch.refine import blockform
    from intrinsic3d_torch.refine.residuals import Params, total_cost
    from intrinsic3d_torch.synthetic import BENCH_PROBLEM, build_sphere_problem

    prob = build_sphere_problem(**BENCH_PROBLEM, device="cpu")
    layout = prob.level().layout
    asm, masks = prob.assemble()
    bparams, basm, _ = blockform.to_block_problem(layout, prob.topo.coords, asm, masks, prob.params, device="cpu")

    def cast(tup, dtype):
        return type(tup)(*(v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v for v in tup))

    def cost_grad(fn, params):
        leaves = [p.detach().requires_grad_(True) for p in params]
        cost = fn(Params(*leaves))
        return float(cost.detach()), Params(*torch.autograd.grad(cost, leaves))

    grads = {}
    for dtype in (torch.float32, torch.float64):
        a, b = cast(asm, dtype), cast(basm, dtype)
        c_t, g_t = cost_grad(lambda p: total_cost(p, a), cast(prob.params, dtype))
        c_b, g_b = cost_grad(
            lambda p: 0.5 * torch.sum(blockform.block_all_residuals(p, b, masked=False) ** 2), cast(bparams, dtype)
        )
        g_b = g_b._replace(sdf=blockform.dense_to_table(layout, g_b.sdf),
                           albedo=blockform.dense_to_table(layout, g_b.albedo))
        grads[dtype] = (g_t, g_b)
        print(f"{dtype}: cost flat {c_t!r} block {c_b!r}")
    (t32, b32), (t64, b64) = grads[torch.float32], grads[torch.float64]
    for leaf in Params._fields:
        g = lambda t: getattr(t, leaf).to(torch.float64)  # noqa: E731
        print(f"  {leaf}: max |g| {float(g(t64).abs().max()):.6g}; flat - block: float32 "
              f"{float((g(t32) - g(b32)).abs().max()):.3e}, float64 {float((g(t64) - g(b64)).abs().max()):.3e}; "
              f"float32 - float64: flat {float((g(t32) - g(t64)).abs().max()):.3e}, "
              f"block {float((g(b32) - g(b64)).abs().max()):.3e}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="what", required=True)
    a = sub.add_parser("apps")
    a.add_argument("--iterations", type=int, default=3)
    a.add_argument("--noise", type=float, nargs="*", default=[])
    sub.add_parser("twins")
    sub.add_parser("blur")
    sub.add_parser("flat")
    args = p.parse_args(argv)
    if args.what == "apps":
        report_apps(args.iterations, args.noise)
    elif args.what == "twins":
        report_twins()
    elif args.what == "flat":
        report_flat()
    else:
        report_blur()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
