"""The port's CUDA kernels against their plain PyTorch versions.

This file imports torch and numpy only, so it also runs on a machine without
JAX. The tests marked `cuda` need the card and skip without one; run them
there with

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -o addopts="" -q

(`--noconftest`: the suite's conftest imports JAX). Tolerances: the
bicubic kernel fuses its tap sums into FMAs where the plain version rounds
each product, so they agree to float32 rounding (rtol 1e-5, atol 1e-5 on
unit-range images); the nearest-pixel read is exact; the distance-transform
sweeps agree bit for bit in sdf and weight (one rounding per candidate, as in
the plain version).
"""

import numpy as np
import pytest
import torch

from intrinsic3d_torch.ops import bicubic, build, distance_transform

NO_LAUNCHES = dict.fromkeys(build.LAUNCHES, 0)


def _rows_problem(seed, k=8, h=240, w=320, m=8 * 40 * 512):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0.0, 1.0, (k, h, w)).astype(np.float32)
    fid = rng.integers(0, k, m).astype(np.int32)
    x = rng.uniform(-2.0, w + 1.0, m).astype(np.float32)
    y = rng.uniform(-2.0, h + 1.0, m).astype(np.float32)
    active = (rng.uniform(size=m) < 0.6).astype(np.float32)
    return images, fid, x, y, active


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels of intrinsic3d_torch/csrc run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_bicubic_rows_kernel_matches_plain(cuda_device):
    dev = [torch.as_tensor(a, device=cuda_device) for a in _rows_problem(13)]
    bicubic.reset_launches()
    xt = dev[2].clone().requires_grad_(True)
    yt = dev[3].clone().requires_grad_(True)
    out = bicubic.bicubic_rows(dev[0], dev[1], xt, yt, dev[4])
    gx, gy = torch.autograd.grad(out, (xt, yt), grad_outputs=torch.ones_like(out))
    fwd_only = bicubic.bicubic_rows(*dev)
    torch.cuda.synchronize()
    val, ddx, ddy = bicubic.bicubic_rows_plain(*dev)
    for got, want in ((out, val), (fwd_only, val), (gx, ddx), (gy, ddy)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert bicubic.LAUNCHES == dict(NO_LAUNCHES, bicubic_rows_fwd=1, bicubic_rows_fwdgrad=1)


@pytest.mark.cuda
def test_nearest_rows_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(17)
    k, h, w, m = 8, 240, 320, 8 * 100 * 512
    depths = torch.as_tensor(rng.uniform(0.3, 5.0, (k, h, w)).astype(np.float32), device=cuda_device)
    ints = [
        torch.as_tensor(a.astype(np.int32), device=cuda_device)
        for a in (rng.integers(0, k, m), rng.integers(0, h, m), rng.integers(0, w, m))
    ]
    active = torch.as_tensor((rng.uniform(size=m) < 0.3).astype(np.float32), device=cuda_device)
    bicubic.reset_launches()
    got = bicubic.nearest_rows(depths, *ints, active)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, bicubic.nearest_rows_plain(depths, *ints, active), rtol=0, atol=0)
    assert bicubic.LAUNCHES["nearest_rows"] == 1


@pytest.mark.cuda
def test_kernel_wrappers_refuse_bad_inputs_on_the_card(cuda_device):
    images, fid, x, y, active = (torch.as_tensor(a, device=cuda_device) for a in _rows_problem(19, m=1024))
    with pytest.raises(ValueError):
        bicubic.bicubic_rows(images, fid.long(), x, y, active)  # int64 frame ids
    with pytest.raises(ValueError):
        bicubic.bicubic_rows(images, fid, x[::2], y[::2], active[::2])  # not contiguous
    with pytest.raises(ValueError):
        bicubic.bicubic_rows(images, fid.cpu(), x, y, active)  # mixed devices


@pytest.mark.cuda
def test_outer_step_on_the_card_matches_the_cpu_path(cuda_device):
    """Two chained outer steps of a small problem: kernels on the card vs the
    plain versions on the CPU, at converged-solve settings (rtol 1e-3)."""
    from intrinsic3d_torch.synthetic import build_sphere_problem

    traj = {}
    for device in ("cuda", "cpu"):
        prob = build_sphere_problem(
            voxel_size=0.02, image_size=(64, 48), num_frames=2, num_observations=2,
            perturb_sdf=0.002, perturb_albedo=0.05, device=device,
        )
        level = prob.level()
        p, mu, traj[device] = level.params, torch.tensor(0.3, device=device), []
        for _ in range(2):
            p, c0, c1, mu, tries = level.outer_step(
                p, prob.depths, prob.images, mu, lm_steps=3, cg_iters=200, cg_eta=1e-8,
                schur_globals=True, cg_coeff_dtype="float32",
            )
            traj[device].append((float(c0), float(c1), tries))
    assert [t[2] for t in traj["cuda"]] == [t[2] for t in traj["cpu"]]
    np.testing.assert_allclose([t[:2] for t in traj["cuda"]], [t[:2] for t in traj["cpu"]], rtol=1e-3)


@pytest.mark.cuda
def test_bucketed_streamed_level_on_the_card_matches_the_cpu_path(cuda_device):
    """A level of the 3-frame sphere in frame-bucketed elements streamed in 2
    frame chunks (`frame_bucketing="always"` at a budget the planner streams
    in 2 chunks): the card (K1 and K2 over bucket rows, chunked, scatter-adds
    by atomics) against the plain versions on the CPU at converged-solve
    settings (float32 coefficients, 100 CG steps, η = 1e-8): the same plan
    and tries, costs rtol 1e-3, the refined sdf within 1e-4 m."""
    from intrinsic3d_torch.config import RefinementConfig
    from intrinsic3d_torch.refine import optimizer as opt
    from intrinsic3d_torch.synthetic import build_sphere_problem

    cfg = RefinementConfig(num_observations=2, occlusion_distance=0.04, fix_intrinsics=True, fix_distortion=True,
                           iterations=2, lm_steps=4, frame_bucketing="always")
    runs = {}
    for device in ("cuda", "cpu"):
        prob = build_sphere_problem(voxel_size=0.015, image_size=(64, 48), num_frames=3, num_observations=2,
                                    cfg=cfg, perturb_sdf=0.002, perturb_albedo=0.05, device=device)
        nbc = 56  # the scene's exact buckets (tests/test_torch_buckets.py)
        budget = (3 * nbc * 512 * opt._EG_CHUNK_PERSIST_BYTES + 2.5 * nbc * 512 * opt._EG_CHUNK_TRANSIENT_BYTES)
        build.reset_launches()
        params, _, st = opt.optimize_level(
            prob.grid, prob.topo, prob.params, cfg, prob.cam, prob.depths, prob.images,
            prob.voxel_sh, prob.thres_shell, 0, cg_iters=100, cg_eta=1e-8, cg_coeff_dtype="float32",
            budget=budget, device=device,
        )
        runs[device] = (st, params, dict(build.LAUNCHES))
    (tst, tp, tn), (cst, cp, cn) = runs["cuda"], runs["cpu"]
    assert tst.reason == cst.reason and tst.eg_chunks == cst.eg_chunks == 2 and tst.bucket_blocks == 56
    assert tn["bicubic_rows_fwdgrad"] > 0 and tn["bicubic_rows_fwd"] > 0 and tn["nearest_rows"] > 0
    assert cn == NO_LAUNCHES
    assert tst.tries == cst.tries
    np.testing.assert_allclose(tst.costs_before + tst.costs_after, cst.costs_before + cst.costs_after, rtol=1e-3)
    np.testing.assert_allclose(tp.sdf.cpu().numpy(), cp.sdf.numpy(), atol=1e-4)


def _random_field(shape, density, seed):
    rng = np.random.default_rng(seed)
    sdf = rng.normal(0.0, 0.05, shape).astype(np.float32)
    w = (rng.uniform(size=shape) < density).astype(np.float32) * rng.uniform(1.0, 5.0, shape).astype(np.float32)
    return sdf, w


# shapes that stress the plan's edges: a dim smaller than the tile, a dim
# smaller than the sweeps of a launch, Z = 1, dims that are no multiples of
# the tile, and the fusion path's window shape at low density
DT_SHAPES = [((9, 5, 12), 0.4), ((3, 18, 20), 0.4), ((12, 10, 1), 0.5), ((40, 37, 61), 0.3), ((73, 63, 73), 0.05)]


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 3, 7, 10, 11])
@pytest.mark.parametrize("shape,density", DT_SHAPES, ids=["x".join(map(str, s)) for s, _ in DT_SHAPES])
def test_correct_sdf_dense_kernel_matches_plain(cuda_device, shape, density, iters):
    sdf, w = (torch.as_tensor(a, device=cuda_device) for a in _random_field(shape, density, 31))
    want_s, want_w = distance_transform.correct_sdf_dense_plain(sdf, w, 0.004, iters)
    build.reset_launches()
    got_s, got_w = distance_transform.correct_sdf_dense(sdf, w, 0.004, iters)
    torch.cuda.synchronize()
    plan = distance_transform.sweep_plan(shape, iters)
    assert build.LAUNCHES == dict(NO_LAUNCHES, correct_sdf_dense=len(plan.sweeps))
    assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))  # bit for bit
    assert torch.equal(got_w, want_w)
    assert not torch.equal(got_s, sdf)  # the sweeps did work
    with pytest.raises(ValueError):
        distance_transform.correct_sdf_dense(sdf, w[:, :, :-1].contiguous(), 0.004, iters)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [
    distance_transform.SweepPlan((9,), 4, 32, 4),     # more sweeps than the kernel's bit masks hold
    distance_transform.SweepPlan((5,), 16, 48, 4),    # columns no multiple of 32
    distance_transform.SweepPlan((2,), 40, 128, 4),   # more threads than the launch bound
    distance_transform.SweepPlan((8,), 80, 32, 4),    # more shared memory than a block has
], ids=["sweeps", "cols", "threads", "smem"])
def test_correct_sdf_dense_rejects_a_plan_beyond_the_kernel(cuda_device, plan):
    """The C entry holds the kernel's limits: it launches nothing for such a
    plan and the wrapper raises."""
    sdf, w = (torch.as_tensor(a, device=cuda_device) for a in _random_field((9, 5, 12), 0.4, 31))
    build.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        distance_transform._run_plan(sdf, w, 0.004, plan)
    assert build.LAUNCHES == NO_LAUNCHES


@pytest.mark.cuda
def test_bicubic_sample_kernels_match_plain(cuda_device):
    """K4a (value) and K4b (g·∂x, g·∂y recomputed from the taps) against the
    plain version's value and autograd gradient."""
    images, fid, x, y, active = (torch.as_tensor(a, device=cuda_device) for a in _rows_problem(37))
    g = torch.as_tensor(np.random.default_rng(41).normal(size=x.shape[0]).astype(np.float32), device=cuda_device)
    build.reset_launches()
    xk, yk = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    out = bicubic.bicubic_sample(images, fid, xk, yk, active)
    gx, gy = torch.autograd.grad(out, (xk, yk), grad_outputs=g)
    torch.cuda.synchronize()
    assert build.LAUNCHES == dict(NO_LAUNCHES, bicubic_sample_fwd=1, bicubic_sample_bwd=1)
    xp, yp = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    want = bicubic.bicubic_sample_plain(images, fid, xp, yp, active)
    wx, wy = torch.autograd.grad(want, (xp, yp), grad_outputs=g)
    torch.testing.assert_close(out.detach(), want.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gx, wx, rtol=1e-5, atol=1e-5 * float(wx.abs().max()))
    torch.testing.assert_close(gy, wy, rtol=1e-5, atol=1e-5 * float(wy.abs().max()))


@pytest.mark.cuda
def test_fusion_on_the_card_matches_the_cpu_path(cuda_device, monkeypatch):
    """A small fusion problem (4 orbit frames, 64×48, clip bounds): the
    card's route (dense sweeps, K3) against the CPU's (the gather table),
    which reach the same fixed point — the same voxel set, sdf atol 1e-6,
    weight rtol 1e-5, color atol 1e-3 (matmuls and sums in another order)."""
    from intrinsic3d_torch.apps import app_fusion
    from intrinsic3d_torch.grid import algorithms
    from intrinsic3d_torch.synthetic import build_orbit_dataset, pipeline_configs

    torch.backends.cuda.matmul.allow_tf32 = False
    sensor = build_orbit_dataset(4, 64, 48, center=(0.0, 0.0, 0.6), radius=0.12)
    _, cfg = pipeline_configs(center=(0.0, 0.0, 0.6), radius=0.12)
    windows = []
    dense = distance_transform.correct_sdf_dense
    monkeypatch.setattr(algorithms, "correct_sdf_dense", lambda s, *a: windows.append(s.shape) or dense(s, *a))
    build.reset_launches()
    card = app_fusion.run(sensor, cfg, device="cuda")
    assert len(windows) == 1
    assert build.LAUNCHES["correct_sdf_dense"] == len(distance_transform.sweep_plan(windows[0], 10).sweeps) < 10
    cpu = app_fusion.run(sensor, cfg, device="cpu")
    assert card.num_voxels > 500
    np.testing.assert_array_equal(card.coords, cpu.coords)
    np.testing.assert_allclose(card.sdf, cpu.sdf, atol=1e-6)
    np.testing.assert_allclose(card.weight, cpu.weight, rtol=1e-5)
    np.testing.assert_allclose(card.color, cpu.color, atol=1e-3)


@pytest.mark.cuda
def test_refinement_on_the_card_matches_the_cpu_path(cuda_device):
    """The JAX package's end-to-end scene (5 frames at 96×72, 2 grid and 2
    pyramid levels) refined from one fused grid on the card (K1, K2) and on
    the CPU (their plain versions) at converged solver settings (float32
    coefficients, 100 CG steps, η = 1e-8): the same schedule and LM tries,
    per-level costs rtol 1e-3, the same final voxel set, refined sdf atol
    1e-4 m, albedo atol 1e-3 and color atol 0.5 (0..255) — reductions in
    another order, compounded over 9 outer iterations and a recoloring."""
    from intrinsic3d_torch.apps import app_fusion
    from intrinsic3d_torch.config import FusionConfig
    from intrinsic3d_torch.refine.intrinsic3d import Intrinsic3D
    from intrinsic3d_torch.synthetic import SMALL_REFINEMENT, SMALL_VOXEL, small_refinement_sensor

    torch.backends.cuda.matmul.allow_tf32 = False
    fused = app_fusion.run(
        small_refinement_sensor(), FusionConfig(voxel_size=SMALL_VOXEL, discont_window_size=0), device="cpu"
    )
    runs = {}
    for device in ("cuda", "cpu"):
        engine = Intrinsic3D(SMALL_REFINEMENT, small_refinement_sensor(), range(5), cg_iters=100, device=device,
                             cg_coeff_dtype="float32", cg_eta=1e-8)
        levels = []
        engine.add_callback(lambda i: levels.append((i.grid_level, i.pyramid_level, i.stats)))
        build.reset_launches()
        runs[device] = (levels, engine.refine(fused), dict(build.LAUNCHES))
    (tl, tg, tn), (cl, cg, cn) = runs["cuda"], runs["cpu"]
    assert tn["bicubic_rows_fwdgrad"] > 0 and tn["bicubic_rows_fwd"] > 0 and tn["nearest_rows"] > 0
    assert cn == NO_LAUNCHES
    assert [lv[:2] for lv in tl] == [lv[:2] for lv in cl] == [(1, 1), (1, 0), (0, 0)]
    for (_, _, a), (_, _, b) in zip(tl, cl):
        assert a.tries == b.tries
        np.testing.assert_allclose(a.costs_before + a.costs_after, b.costs_before + b.costs_after, rtol=1e-3)
    assert tg.voxel_size == cg.voxel_size == SMALL_VOXEL / 2
    np.testing.assert_array_equal(tg.coords, cg.coords)
    np.testing.assert_allclose(tg.sdf_refined, cg.sdf_refined, atol=1e-4)
    np.testing.assert_allclose(tg.albedo, cg.albedo, atol=1e-3)
    np.testing.assert_allclose(tg.color, cg.color, atol=0.5)


# ---------------------------------------------------------------------------
# What runs without a card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_flat_path_on_the_card_matches_the_cpu_path(cuda_device):
    """The flat-table oracle on `test_blockform.py`'s small sphere: the
    assembly (through the depth-probe and bicubic kernels), the Jacobi
    diagonal and one GN step (3 LM tries, 6 CG steps) on the card against
    the CPU path. Element sets equal, weights rtol 1e-5; diagonal rtol 1e-3
    (atomic scatter-adds); costs rtol 1e-4 and equal tries."""
    from intrinsic3d_torch.refine.solver import gn_iteration, jtj_diag
    from intrinsic3d_torch.synthetic import build_sphere_problem

    out = {}
    build.reset_launches()
    for dev in (cuda_device, torch.device("cpu")):
        prob = build_sphere_problem(
            voxel_size=0.02, image_size=(64, 48), num_frames=2, num_observations=2, perturb_sdf=0.002,
            perturb_albedo=0.05, device=dev,
        )
        asm, masks = prob.assemble()
        diag = jtj_diag(prob.params, asm)
        _, c0, c1, _, tries = gn_iteration(prob.params, asm, masks, 1e-4, lm_steps=3, cg_iters=6, device=dev)
        out[dev.type] = (asm, diag, float(c0), float(c1), tries)
    launches = dict(build.LAUNCHES)
    (ga, gd, g0, g1, gt), (ca, cd, c0, c1, ct) = out["cuda"], out["cpu"]
    torch.testing.assert_close(ga.eg_frame.cpu(), ca.eg_frame)
    torch.testing.assert_close(ga.eg_sdf10_idx.cpu(), ca.eg_sdf10_idx)
    torch.testing.assert_close(ga.eg_w.cpu(), ca.eg_w, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(ga.lam.cpu(), ca.lam, rtol=1e-5, atol=0.0)
    for got, want in zip(gd, cd):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3 * float(want.abs().max()))
    assert gt == ct
    np.testing.assert_allclose([g0, g1], [c0, c1], rtol=1e-4)
    assert g1 < g0
    assert launches["nearest_rows"] > 0 and launches["bicubic_rows_fwd"] > 0 and launches["bicubic_rows_fwdgrad"] > 0


def test_cpu_tensors_take_the_plain_versions():
    images, fid, x, y, active = (torch.as_tensor(a) for a in _rows_problem(23, k=2, h=24, w=32, m=2048))
    bicubic.reset_launches()
    val, _, _ = bicubic.bicubic_rows_plain(images, fid, x, y, active)
    torch.testing.assert_close(bicubic.bicubic_rows(images, fid, x, y, active), val, rtol=0, atol=0)
    yi = torch.clamp(y.long(), 0, 23).to(torch.int32)
    xi = torch.clamp(x.long(), 0, 31).to(torch.int32)
    torch.testing.assert_close(
        bicubic.nearest_rows(images, fid, yi, xi, active),
        bicubic.nearest_rows_plain(images, fid, yi, xi, active), rtol=0, atol=0,
    )
    assert bicubic.LAUNCHES == NO_LAUNCHES


def test_plain_bicubic_reproduces_an_affine_image():
    """Catmull-Rom reproduces linear functions exactly: on I(f, r, c) =
    a·c + b·r + f the value is a·x + b·y + f and the derivatives a and b
    (inside the clip range)."""
    k, h, w, m = 3, 20, 30, 500
    a, b = 0.25, -0.5
    f_ = torch.arange(k, dtype=torch.float64).view(k, 1, 1)
    images = (a * torch.arange(w, dtype=torch.float64).view(1, 1, w)
              + b * torch.arange(h, dtype=torch.float64).view(1, h, 1) + f_)
    rng = np.random.default_rng(29)
    fid = torch.as_tensor(rng.integers(0, k, m).astype(np.int32))
    x = torch.as_tensor(rng.uniform(1.0, w - 2.01, m))
    y = torch.as_tensor(rng.uniform(1.0, h - 2.01, m))
    val, ddx, ddy = bicubic.bicubic_rows_plain(images, fid, x, y, torch.ones(m, dtype=torch.float64))
    torch.testing.assert_close(val, a * x + b * y + fid.double(), rtol=0, atol=1e-12)
    torch.testing.assert_close(ddx, torch.full_like(x, a), rtol=0, atol=1e-12)
    torch.testing.assert_close(ddy, torch.full_like(x, b), rtol=0, atol=1e-12)


def test_kernel_sources_and_build_paths():
    for name in build.SOURCES:
        src = build.CSRC / f"{name}.cu"
        text = src.read_text()
        assert f"i3d_{name}" in text and "cudaGetLastError" in text
        assert build.lib_path(name).parent == build.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
