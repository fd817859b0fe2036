"""The port's CUDA kernels against their plain PyTorch versions.

This file imports torch and numpy only, so it also runs on a machine without
JAX. The tests marked `cuda` need the card and skip without one; run them
there with

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -o addopts="" -q

(`--noconftest`: the suite's conftest imports JAX). Tolerances: the
bicubic kernel fuses its tap sums into FMAs where the plain version rounds
each product, so they agree to float32 rounding (rtol 1e-5, atol 1e-5 on
unit-range images); the nearest-pixel read is exact.
"""

import numpy as np
import pytest
import torch

from intrinsic3d_torch.ops import bicubic, build


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
    assert bicubic.LAUNCHES == {"bicubic_rows_fwd": 1, "bicubic_rows_fwdgrad": 1, "nearest_rows": 0}


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


# ---------------------------------------------------------------------------
# What runs without a card
# ---------------------------------------------------------------------------


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
    assert bicubic.LAUNCHES == {"bicubic_rows_fwd": 0, "bicubic_rows_fwdgrad": 0, "nearest_rows": 0}


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
