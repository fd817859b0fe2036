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

from intrinsic3d_torch.ops import bicubic, build, distance_transform, roofline

from torch_support import cuda_device, one_torch_thread, random_field  # noqa: F401

NO_LAUNCHES = dict.fromkeys(build.LAUNCHES, 0)


def _rows_problem(seed, k=8, h=240, w=320, m=8 * 40 * 512):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0.0, 1.0, (k, h, w)).astype(np.float32)
    fid = rng.integers(0, k, m).astype(np.int32)
    x = rng.uniform(-2.0, w + 1.0, m).astype(np.float32)
    y = rng.uniform(-2.0, h + 1.0, m).astype(np.float32)
    active = (rng.uniform(size=m) < 0.6).astype(np.float32)
    return images, fid, x, y, active


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


# K1a, K1b and K2 through the element stream of csrc/rows_common.cuh: ragged
# lengths (vector groups and a scalar tail), 512-element inactive runs,
# storage offsets (only 4-byte aligned: scalar loads)
STREAM_M = [0, 1, 3, 4, 5, 511, 512, 513, 2**20 + 3]
STREAM_KERNELS = ["bicubic_rows_fwd", "bicubic_rows_fwdgrad", "nearest_rows"]


def _stream_problem(kernel, m, seed, offsets=(0, 0, 0, 0), pattern="runs", k=8, h=240, w=320):
    """K1a or K1b (`bicubic_rows_fwd`, `bicubic_rows_fwdgrad`: fid, x, y,
    active) or K2 (`nearest_rows`: fid, yi, xi, active) inputs on the card,
    frame-major in 512-element blocks: every third block wholly inactive and
    70% of the rest active (`pattern` "runs"), or none active ("none").
    Array i is a view starting `offsets[i]` elements into a larger tensor.
    The bicubic coordinates reach past the frame and include NaNs."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0.3, 5.0, (k, h, w)).astype(np.float32)
    fid = (np.arange(m) // 512 * k // max(1, -(-m // 512))).astype(np.int32)
    x = rng.uniform(-3.0, w + 2.0, m).astype(np.float32)
    y = rng.uniform(-3.0, h + 2.0, m).astype(np.float32)
    active = (rng.uniform(size=m) < 0.7).astype(np.float32)
    active[(np.arange(m) // 512) % 3 == 1] = 0.0
    if pattern == "none":
        active[:] = 0.0
    if kernel != "nearest_rows":
        x[::97] = np.nan
        y[5::89] = np.nan
        a, b = x, y
    else:
        a = np.clip(np.floor(y + 0.5), 0, h - 1).astype(np.int32)
        b = np.clip(np.floor(x + 0.5), 0, w - 1).astype(np.int32)

    def on_card(arr, off):
        big = torch.zeros(off + arr.shape[0] + 5, dtype=torch.as_tensor(arr[:0]).dtype, device="cuda")
        big[off:off + arr.shape[0]] = torch.as_tensor(arr, device="cuda")
        return big[off:off + arr.shape[0]]

    return (torch.as_tensor(images, device="cuda"),
            *(on_card(arr, off) for arr, off in zip((fid, a, b, active), offsets)))


def _stream_want(kernel, images, fid, a, b, active):
    """The plain version's outputs (K1a: the value; K1b: value, ddx, ddy;
    K2: the depths). A NaN coordinate samples the clip corner, and its
    derivative is 0 (the unclipped NaN fails the range mask)."""
    if kernel == "nearest_rows":
        return (bicubic.nearest_rows_plain(images, fid, a, b, active),)
    val, ddx, ddy = bicubic.bicubic_rows_plain(images, fid, torch.nan_to_num(a, nan=1.0),
                                               torch.nan_to_num(b, nan=1.0), active)
    if kernel == "bicubic_rows_fwd":
        return (val,)
    return val, torch.where(torch.isnan(a), 0.0, ddx), torch.where(torch.isnan(b), 0.0, ddy)


def _stream_check(kernel, inputs):
    """One launch through the wrapper (K1b through `_launch_bicubic` with
    derivatives), and the plain version's outputs (K2 exactly, K1a's value
    and K1b's three outputs to float32 rounding, rtol 1e-5). Returns the
    outputs."""
    bicubic.reset_launches()
    if kernel == "bicubic_rows_fwd":
        got = (bicubic.bicubic_rows(*inputs),)
    elif kernel == "bicubic_rows_fwdgrad":
        got = bicubic._launch_bicubic(*inputs, True)
    else:
        got = (bicubic.nearest_rows(*inputs),)
    torch.cuda.synchronize()
    assert bicubic.LAUNCHES == dict(NO_LAUNCHES, **{kernel: 1})
    for g, want in zip(got, _stream_want(kernel, *inputs), strict=True):
        if kernel == "nearest_rows":
            assert torch.equal(g, want)
        else:
            assert torch.isfinite(g).all()
            torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()) if want.numel() else 0.0)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", STREAM_KERNELS)
@pytest.mark.parametrize("m", STREAM_M)
def test_sampler_streams_match_plain_on_ragged_lengths(cuda_device, kernel, m):
    _stream_check(kernel, _stream_problem(kernel, m, seed=m))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", STREAM_KERNELS)
@pytest.mark.parametrize("offsets", [(1, 1, 1, 1), (2, 2, 2, 2), (3, 3, 3, 3), (1, 0, 3, 2)])
def test_sampler_streams_take_storage_offsets(cuda_device, kernel, offsets):
    """Views `t[off:]` of larger tensors, 4-byte aligned only, with the same
    offset on every input or mixed offsets: the kernel reads them with
    scalar loads, the outputs (allocated by the wrapper) being aligned."""
    for m in (5, 513, 4099):
        _stream_check(kernel, _stream_problem(kernel, m, seed=m + sum(offsets), offsets=offsets))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", STREAM_KERNELS)
def test_sampler_streams_all_inactive(cuda_device, kernel):
    for m in (3, 512, 2**20 + 3):
        for got in _stream_check(kernel, _stream_problem(kernel, m, seed=m, pattern="none")):
            assert torch.equal(got, torch.zeros_like(got))


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
    in 2 chunks): the card (the E_g kernel and K2 over bucket rows, chunked,
    scatter-adds by atomics) against the eager E_g pass and the plain
    versions on the CPU at converged-solve
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
    assert tn["eg_rows_lin"] > 0 and tn["eg_rows_value"] > 0 and tn["nearest_rows"] > 0
    assert cn == NO_LAUNCHES
    assert tst.tries == cst.tries
    np.testing.assert_allclose(tst.costs_before + tst.costs_after, cst.costs_before + cst.costs_after, rtol=1e-3)
    np.testing.assert_allclose(tp.sdf.cpu().numpy(), cp.sdf.numpy(), atol=1e-4)


# shapes that stress the plan's edges: a dim smaller than the tile, a dim
# smaller than the sweeps of a launch, Z = 1, dims that are no multiples of
# the tile, and the fusion path's window shape at low density
DT_SHAPES = [((9, 5, 12), 0.4), ((3, 18, 20), 0.4), ((12, 10, 1), 0.5), ((40, 37, 61), 0.3), ((73, 63, 73), 0.05)]


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 3, 7, 10, 11])
@pytest.mark.parametrize("shape,density", DT_SHAPES, ids=["x".join(map(str, s)) for s, _ in DT_SHAPES])
def test_correct_sdf_dense_kernel_matches_plain(cuda_device, shape, density, iters):
    sdf, w = (torch.as_tensor(a, device=cuda_device) for a in random_field(shape, density, 31))
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
    sdf, w = (torch.as_tensor(a, device=cuda_device) for a in random_field((9, 5, 12), 0.4, 31))
    build.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        distance_transform._run_plan(sdf, w, 0.004, plan)
    assert build.LAUNCHES == NO_LAUNCHES


def _shell_grid(radius: int, seed: int):
    """A sphere shell of SBR voxels 4.4 voxels thick, 5% of them taken out
    (absent corners) and 15% of weight 0: about 68 k voxels at radius 36
    and 270 k at 72, the parents of the benchmark capture's two grid-level
    boundaries (65 k and 261 k)."""
    from intrinsic3d_torch.grid.voxel_grid import VoxelGrid

    rng = np.random.default_rng(seed)
    r = np.arange(-radius - 3, radius + 4)
    c = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    c = c[(np.abs(np.linalg.norm(c + 0.5, axis=1) - radius) < 2.2) & (rng.random(len(c)) > 0.05)]
    g = VoxelGrid.from_coords(0.002, c.astype(np.int64), sbr=True)
    n = g.num_voxels
    g.sdf = (rng.normal(size=n) * 0.004).astype(np.float32)
    g.weight = np.where(rng.random(n) < 0.85, rng.random(n) * 5, 0.0).astype(np.float32)
    g.color = (rng.random((n, 3)) * 255).astype(np.float32)
    g.albedo = rng.random(n).astype(np.float32)
    g.sdf_refined = (rng.normal(size=n) * 0.004).astype(np.float32)
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [36, 72], ids=["g2-g1", "g1-g0"])
def test_upsample_kernel_is_bitwise_the_host_path(cuda_device, radius):
    """`upsample` on the card (one kernel launch) and on the CPU (host
    numpy) give the same child grid bit for bit, at both boundary sizes."""
    from intrinsic3d_torch.grid import algorithms as alg

    g = _shell_grid(radius, 31 + radius)
    build.reset_launches()
    card = alg.upsample(g, device=cuda_device)
    assert build.LAUNCHES == dict(NO_LAUNCHES, upsample_fields=1)
    host = alg.upsample(g, device="cpu")
    assert build.LAUNCHES == dict(NO_LAUNCHES, upsample_fields=1)
    np.testing.assert_array_equal(card.coords, host.coords)
    for k in ("sdf", "weight", "color", "albedo", "sdf_refined"):
        a, b = getattr(card, k), getattr(host, k)
        assert a.dtype == b.dtype == np.float32 and a.flags.c_contiguous, k
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=k)
    assert (host.weight == 0.0).any() and (host.weight > 0.0).any()


@pytest.mark.cuda
def test_upsample_kernel_refuses_bad_inputs(cuda_device):
    from intrinsic3d_torch.grid import algorithms as alg
    from intrinsic3d_torch.ops.upsample import FIELDS, upsample_fields

    g = _shell_grid(6, 3)
    idx, _, order = alg._upsample_skeleton(g)
    fields = {k: torch.as_tensor(getattr(g, k), device=cuda_device) for k in FIELDS}
    idx, order = torch.as_tensor(idx, device=cuda_device), torch.as_tensor(order, device=cuda_device)
    build.reset_launches()
    strided = torch.empty((g.num_voxels, 4), device=cuda_device)[:, :3]
    strided.copy_(fields["color"])
    for bad, args in {"float64": (dict(fields, sdf=fields["sdf"].double()), idx, order),
                      "int64 order": (fields, idx, order.long()),
                      "not contiguous": (dict(fields, color=strided), idx, order),
                      "on the CPU": ({k: v.cpu() for k, v in fields.items()}, idx.cpu(), order.cpu()),
                      "mixed devices": (fields, idx.cpu(), order)}.items():
        with pytest.raises(ValueError):
            upsample_fields(*args)
            pytest.fail(bad)
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
    pyramid levels) refined from one fused grid on the card (the E_g kernel,
    K2, one upsample kernel launch) and on the CPU (the eager E_g pass, K2's
    plain version, the host upsample) at converged
    solver settings (float32
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
    assert tn["eg_rows_lin"] > 0 and tn["eg_rows_value"] > 0 and tn["nearest_rows"] > 0
    assert tn["upsample_fields"] == 1  # one grid-level boundary
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


@pytest.mark.cuda
def test_level_with_a_prep_on_the_card_matches_the_serial_level(cuda_device):
    """One frame-bucketed level of the small sphere problem on the card, its
    host half built by a `LevelPrep` thread (started before and joined in
    `optimize_level`) and serially: the same plan, bucket width and chunks,
    first cost within rtol 1e-6 (the same inputs through atomic
    scatter-adds), costs rtol 1e-3 after it, the E_g kernel (both modes)
    and K2 launched by both runs, and no prep thread left."""
    import threading

    from intrinsic3d_torch.config import RefinementConfig
    from intrinsic3d_torch.prefetch import HostPrep
    from intrinsic3d_torch.refine import optimizer as opt
    from intrinsic3d_torch.synthetic import build_sphere_problem

    cfg = RefinementConfig(num_observations=2, occlusion_distance=0.04, fix_poses=False, frame_bucketing="always",
                           iterations=2, lm_steps=4)
    tp = build_sphere_problem(voxel_size=0.015, image_size=(64, 48), num_frames=3, num_observations=2,
                              perturb_sdf=0.002, perturb_albedo=0.05, cfg=cfg, device=cuda_device)
    runs = {}
    for with_prep in (True, False):
        grid = tp.grid.clone()
        prep = None
        if with_prep:
            prep = opt.LevelPrep(grid, None, tp.params, cfg, tp.depths.cpu().numpy(), tp.thres_shell, 0,
                                 budget=opt.level_budget(cuda_device))
        build.reset_launches()
        _, _, st = opt.optimize_level(grid, None, tp.params, cfg, tp.cam, tp.depths, tp.images, tp.voxel_sh,
                                      tp.thres_shell, 0, cg_iters=4, device=cuda_device, prep=prep)
        runs[with_prep] = (st, dict(build.LAUNCHES))
    (a, la), (b, lb) = runs[True], runs[False]
    assert (a.reason, a.bucket_blocks, a.eg_chunks, a.num_blocks) == (b.reason, b.bucket_blocks, b.eg_chunks,
                                                                      b.num_blocks)
    assert a.bucket_blocks > 0 and a.prefetch_seconds > 0.0 and b.prefetch_seconds == 0.0
    np.testing.assert_allclose(a.costs_before[0], b.costs_before[0], rtol=1e-6)
    np.testing.assert_allclose(a.costs_before + a.costs_after, b.costs_before + b.costs_after, rtol=1e-3)
    for launches in (la, lb):
        assert launches["eg_rows_lin"] > 0 and launches["eg_rows_value"] > 0
        assert launches["nearest_rows"] > 0
    assert not [t for t in threading.enumerate() if t.name.startswith(HostPrep.THREAD_PREFIX)]


# ---------------------------------------------------------------------------
# The E_g element pass (csrc/eg_rows.cu)
# ---------------------------------------------------------------------------


def _eg_scene(device, block=8, bucketed=False, lens=False):
    """The 5-frame sphere's level on `device` (tests/test_torch_eg_rows.py's
    scene): its assembly at the start point, dense or frame-bucketed (pad
    bucket rows), with `block`³-lane blocks (3: 27 lanes and an odd block
    count, so chunks end in a ragged tail and start unaligned), and a
    candidate point whose frame 0 sits at the sphere's centre, so that
    active elements fall behind the camera and outside the image beside
    valid ones. With `lens` the frames are rendered through
    tests/test_torch_eg_rows.py's distorted lens, the assembly and the
    candidate take that lens, and the candidate's intrinsics lie off the
    rendering pinhole (focal lengths x 1.005, principal point +1.5, -1.0
    px). Returns (params, assembly)."""
    from intrinsic3d_torch.grid.blocks import BlockLayout
    from intrinsic3d_torch.mathutil import transform_points
    from intrinsic3d_torch.refine import blockform
    from intrinsic3d_torch.refine.optimizer import _bmap_on, prepare_level
    from intrinsic3d_torch.synthetic import DEFAULT_CENTER, build_sphere_problem

    prob = build_sphere_problem(voxel_size=0.02, image_size=(64, 48), num_frames=5, num_observations=3,
                                perturb_sdf=0.002, perturb_albedo=0.05, dist=EG_LENS if lens else None,
                                device=device)
    layout = BlockLayout.build(prob.grid, block=block, blocks_multiple=8 if block == 8 else 1)
    bmap = None
    if bucketed:
        bmap = blockform.build_frame_buckets(layout, prob.params.poses.cpu().numpy(), prob.params.intr.cpu().numpy(),
                                             64, 48, prob.grid.voxel_size, depths=prob.depths.cpu().numpy(),
                                             occlusion=0.02)
    level = prepare_level(prob.grid, prob.topo, prob.voxel_sh, prob.params, prob.cfg, prob.thres_shell, 64, 48,
                          (prob.cfg.lambda_g, 10.0, 10.0, prob.cfg.lambda_a), device=device, layout=layout)
    level = level._replace(bmap=_bmap_on(bmap, torch.device(device)))
    asm, _ = level.assemble(level.params, prob.depths, prob.images)
    poses = level.params.poses.clone()
    centre = torch.as_tensor(DEFAULT_CENTER, dtype=torch.float32, device=device)
    poses[0, 5] -= transform_points(poses[0], centre)[2]
    params = level.params._replace(poses=poses)
    if lens:
        off = torch.tensor([0.0, 0.0, 1.5, -1.0], device=device)
        params = params._replace(intr=params.intr * torch.tensor([1.005, 1.005, 1.0, 1.0], device=device) + off)
    return params, asm


def _field_close(got, want, rel, bf16=False):
    """Within `rel` x the field's largest magnitude (in float64), with
    `bf16` besides within one bfloat16 ulp of `want`."""
    got, w64 = got.double(), want.double()
    slack = rel * float(w64.abs().max())
    if bf16:
        slack = slack + torch.pow(2.0, torch.floor(torch.log2(torch.clamp(w64.abs(), min=2.0**-126))) - 7)
    assert bool(((got - w64).abs() <= slack).all()), float((got - w64).abs().max())


# the lens of tests/test_pose_refinement.py::test_distortion_recovery (k1 k2 k3 p1 p2)
EG_LENS = (0.08, -0.04, 0.0, 0.10, -0.06)
EG_CASES = [(8, False, False, False), (8, True, False, False), (3, False, False, False), (8, False, True, False),
            (8, False, False, True)]
# the float32 element function is only so well conditioned: on this scene the
# plain version's own float32 error against its float64 evaluation reaches
# 1.4e-5 of the residual's largest magnitude and 4e-5 to 9e-5 of each
# coefficient field's (the normal's 1/|g| and the shading difference cancel
# most of their terms), so the kernel is held to the float64 evaluation at
# twice the largest
EG_REL = 2e-4


def _eg_float64(x):
    from intrinsic3d_torch.ops import eg_rows

    return eg_rows.EgRowsInputs(*[t if t is None or not t.is_floating_point() else t.double() for t in x])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "value"])
@pytest.mark.parametrize("block,bucketed,strided,lens", EG_CASES,
                         ids=["dense", "bucketed", "ragged", "strided", "lens"])
def test_eg_rows_kernel_matches_plain(cuda_device, block, bucketed, strided, lens, mode):
    """The E_g kernel over three frame chunks (2, 2 and 1 rows) against
    `eg_rows_plain` evaluated in float64 on the card: residuals, float32
    coefficients and the value mode's partial sums within `EG_REL` x each
    field's largest magnitude, bfloat16 fields besides within one ulp; one
    launch a chunk. `strided`: the weights, the per-slot SH and positions
    are views into wider tensors (a rank's brick of the multi-device path)
    and the poses a transposed copy. `lens`: the distorted projection at a
    nonzero lens and intrinsics off the pinhole (`_eg_scene`)."""
    from intrinsic3d_torch.ops import eg_rows
    from intrinsic3d_torch.refine import blockform

    params, asm = _eg_scene("cuda", block, bucketed, lens)
    sh, sha = asm.sdf_plan.apply(params.sdf), asm.alb_plan.apply(params.albedo)
    x = blockform._eg_inputs(asm, sh, sha, params)
    k, kb, s = asm.eg_w.shape
    if strided:
        d = x.sh.shape[1]
        x = x._replace(sh=torch.cat([x.sh, x.sh[:, :100]], dim=1)[:, :d],
                       vpos=torch.cat([x.vpos[:, :36], x.vpos], dim=1)[:, 36:], poses=x.poses.T.contiguous().T)
        asm = asm._replace(eg_w=torch.cat([asm.eg_w, asm.eg_w[:, :1]], dim=1)[:, :kb])
        assert not any(t.is_contiguous() for t in (x.sh, x.vpos, x.poses, asm.eg_w))
    x64 = _eg_float64(x)
    chunks = blockform._frame_chunks(k, 3)
    build.reset_launches()
    if mode == "value":
        got = [eg_rows.eg_rows_value(x, asm.eg_w[lo:lo + n], lo) for lo, n in chunks]
        torch.cuda.synchronize()
        assert build.LAUNCHES == dict(NO_LAUNCHES, eg_rows_value=3)
        for (lo, n), (r, part) in zip(chunks, got):
            want, _ = eg_rows.eg_rows_plain(x64, asm.eg_w[lo:lo + n].double(), lo, lin=False)
            _field_close(r.reshape(-1), want, EG_REL)
            _field_close(part, eg_rows._value_partials(want), EG_REL)
        return
    dt = getattr(torch, mode)
    r0 = torch.full((k, kb, s), float("nan"), device="cuda")
    coeffs = [torch.full((f, k, kb, s), float("nan"), device="cuda", dtype=dt) for f in eg_rows.FIELDS]
    for lo, n in chunks:
        eg_rows.eg_rows_lin(x, asm.eg_w[lo:lo + n], lo, r0, coeffs)
    torch.cuda.synchronize()
    assert build.LAUNCHES == dict(NO_LAUNCHES, eg_rows_lin=3)
    want = [eg_rows.eg_rows_plain(x64, asm.eg_w[lo:lo + n].double(), lo, lin=True) for lo, n in chunks]
    _field_close(r0.reshape(-1), torch.cat([w[0] for w in want]), EG_REL)
    want_c = torch.cat([w[1].view(29, -1, kb, s) for w in want], dim=1)
    at = 0
    for c, f in zip(coeffs, eg_rows.FIELDS):
        _field_close(c, want_c[at:at + f], EG_REL, bf16=dt == torch.bfloat16)
        at += f
    assert int((r0 != 0).sum()) > 1000 and int((r0 == 0).sum()) > 0.8 * r0.numel()


@pytest.mark.cuda
def test_eg_rows_kernel_all_inactive(cuda_device):
    """Zero weights: every output 0 (written over NaN), partial sums 0."""
    from intrinsic3d_torch.ops import eg_rows
    from intrinsic3d_torch.refine import blockform

    params, asm = _eg_scene("cuda", 3, False)
    sh, sha = asm.sdf_plan.apply(params.sdf), asm.alb_plan.apply(params.albedo)
    x = blockform._eg_inputs(asm, sh, sha, params)
    w0 = torch.zeros_like(asm.eg_w)
    r0 = torch.full(w0.shape, float("nan"), device="cuda")
    coeffs = [torch.full((f, *w0.shape), float("nan"), device="cuda", dtype=torch.bfloat16) for f in eg_rows.FIELDS]
    eg_rows.eg_rows_lin(x, w0[1:], 1, r0, coeffs)
    r, part = eg_rows.eg_rows_value(x, w0, 0)
    torch.cuda.synchronize()
    assert bool((r0[1:] == 0).all()) and bool(r0[0].isnan().all())
    assert all(bool((c[:, 1:] == 0).all()) and bool(c[:, 0].isnan().all()) for c in coeffs)
    assert bool((r == 0).all()) and bool((part == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [1, 3])
def test_eg_pass_on_the_card_launches_once_a_chunk_and_reads_nothing_back(cuda_device, monkeypatch, chunks):
    """`linearize_block_chunked` and `block_total_cost` on the card: one E_g
    kernel launch a frame chunk in each, no sampler launch, no autograd, no
    host read counted (`timer.HOST_READS`) and none at all (the CUDA sync
    debug mode raises on a synchronizing call: a scalar read or a
    synchronous upload); the fused pass counted in `EG_PASSES`."""
    from intrinsic3d_torch import timer
    from intrinsic3d_torch.refine import blockform

    params, asm = _eg_scene("cuda", 8, True)
    blockform.linearize_block_chunked(params, asm, chunks, torch.bfloat16)  # builds the kernel
    torch.cuda.synchronize()

    def no_autograd(*a, **kw):
        raise AssertionError("torch.autograd.grad reached on the card's block path")

    monkeypatch.setattr(torch.autograd, "grad", no_autograd)
    reads, passes = dict(timer.HOST_READS), dict(blockform.EG_PASSES)
    build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cost0, lin = blockform.linearize_block_chunked(params, asm, chunks, torch.bfloat16)
        cost = blockform.block_total_cost(params, asm, chunks)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert build.LAUNCHES == dict(NO_LAUNCHES, eg_rows_lin=chunks, eg_rows_value=chunks)
    assert timer.HOST_READS == reads
    assert blockform.EG_PASSES == dict(passes, fused=passes["fused"] + 2 * chunks)
    assert lin.a_sdf.dtype == torch.bfloat16
    torch.testing.assert_close(cost, cost0, rtol=1e-5, atol=0.0)


# the level test's cases: (scene, level settings)
LEVEL_CASES = {
    # the camera held: three outer iterations of the 2-frame scene
    "held": (dict(num_frames=2, num_observations=2), dict(iterations=3, fix_intrinsics=True, fix_distortion=True)),
    # the camera free, in the PCG beside the voxels: one outer iteration of
    # the 5-frame scene
    "free": (dict(num_frames=5, num_observations=3), dict(iterations=1, fix_intrinsics=False, fix_distortion=False)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LEVEL_CASES))
def test_level_through_the_eg_kernel_matches_the_eager_cpu_level(cuda_device, case):
    """Outer iterations of `optimize_level` on the small sphere of
    `test_blockform.py` (poses free): the card, every E_g pass through the
    kernel, against the CPU, every pass eager, at converged-solve settings
    (float32 coefficients, 100 CG steps, η = 1e-8), held to the bounds
    `test_blockform.py` holds one GN step to (first cost rtol 1e-5, its
    accepted cost rtol 1e-3) and a 3-iteration trajectory to (costs rtol
    1e-2, sdf and poses rtol 5e-2, atol 1e-4; no accepted cost above its
    start). Each outer step re-collects the observations, so the
    trajectory is chaotic at rounding scale: on the CPU, the eager path
    started from an sdf one ulp away moved these costs by up to 0.7% and
    the poses by 1e-3.

    "held": the camera held, three iterations of the 2-frame scene.
    "free": the camera free (`optimizer.level_schur`: its intrinsics and
    distortion in the PCG), its intrinsics and distortion held to the
    trajectory's bounds too. On the 2-frame scene that PCG does not
    converge in 100 steps and a 1e-7 relative change of the start's sdf
    moved the 3-iteration costs by 45% on the CPU; on the 5-frame scene
    the same change moved its 3-iteration poses to 0.9 of their bound, and
    changes of ±1e-6 moved its first iteration's state to at most 0.24 of
    the bounds. So the free case holds one outer iteration of the 5-frame
    scene."""
    from intrinsic3d_torch.config import RefinementConfig
    from intrinsic3d_torch.refine import optimizer as opt
    from intrinsic3d_torch.synthetic import build_sphere_problem

    scene, settings = LEVEL_CASES[case]
    cfg = RefinementConfig(num_observations=scene["num_observations"], occlusion_distance=0.02, lm_steps=4,
                           fix_poses=False, **settings)
    assert opt.level_schur(cfg) == (True if case == "held" else "poses")
    runs = {}
    for device in ("cuda", "cpu"):
        prob = build_sphere_problem(voxel_size=0.02, image_size=(64, 48), **scene, perturb_sdf=0.002,
                                    perturb_albedo=0.05, cfg=cfg, device=device)
        build.reset_launches()
        params, _, st = opt.optimize_level(prob.grid, prob.topo, prob.params, cfg, prob.cam, prob.depths,
                                           prob.images, prob.voxel_sh, prob.thres_shell, 0, cg_iters=100,
                                           cg_eta=1e-8, cg_coeff_dtype="float32", device=device)
        runs[device] = (st, params, dict(build.LAUNCHES), prob.params)
    (tst, tp, tn, _), (cst, cp, cn, start) = runs["cuda"], runs["cpu"]
    assert tst.eg_fused > 0 and tst.eg_eager == 0 and cst.eg_fused == 0 and cst.eg_eager > 0
    assert tn["bicubic_rows_fwd"] == tn["bicubic_rows_fwdgrad"] == 0 and cn == NO_LAUNCHES
    np.testing.assert_allclose(tst.costs_before[0], cst.costs_before[0], rtol=1e-5)
    np.testing.assert_allclose(tst.costs_after[0], cst.costs_after[0], rtol=1e-3)
    np.testing.assert_allclose(tst.costs_before + tst.costs_after, cst.costs_before + cst.costs_after, rtol=1e-2)
    assert all(c1 <= c0 for c0, c1 in zip(tst.costs_before, tst.costs_after))
    np.testing.assert_allclose(tp.sdf.cpu().numpy(), cp.sdf.numpy(), rtol=5e-2, atol=1e-4)
    np.testing.assert_allclose(tp.poses.cpu().numpy(), cp.poses.numpy(), rtol=5e-2, atol=1e-4)
    if case == "free":
        assert not torch.equal(cp.intr, start.intr) and not torch.equal(cp.dist, start.dist)
        np.testing.assert_allclose(tp.intr.cpu().numpy(), cp.intr.numpy(), rtol=5e-2, atol=1e-4)
        np.testing.assert_allclose(tp.dist.cpu().numpy(), cp.dist.numpy(), rtol=5e-2, atol=1e-4)


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


def test_roofline_counts_the_bytes_a_masked_sampler_needs():
    """Every element's flag and output, the words of the active ones only,
    the image stack once; the bound is the larger of the byte and the
    operation times."""
    images = torch.zeros((2, 3, 5), dtype=torch.float32)
    assert roofline.needed_bytes(images, 1000, 10, 4) == 1000 * 8 + 10 * 12 + 30 * 4
    assert roofline.needed_bytes(images, 1000, 10, 8, act_in_bytes=16) == 1000 * 12 + 10 * 16 + 30 * 4
    ms, by = roofline.bound(3.35e9, 0)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = roofline.bound(0, 67e9)
    assert by == "operations" and ms == pytest.approx(1.0)
    # a K1a element's bytes outweigh its operations
    assert roofline.bound(roofline.needed_bytes(images, 1, 1, 4), roofline.BICUBIC_OPS["fwd"])[1] == "bytes"
