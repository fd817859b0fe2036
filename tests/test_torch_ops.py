"""Port parity, kernels and foundations: `intrinsic3d_torch` against `intrinsic3d_tpu`.

Inputs are drawn from a numpy seed and handed to both packages. The JAX
Pallas kernels run in interpret mode on the CPU (as the JAX package's own
tests run them); the port runs its kernels' plain PyTorch versions, which
is what its wrappers do for CPU tensors (the CUDA kernels are held against
those plain versions in `tests/test_torch_kernels.py`).

Tolerances:
- bicubic value/ddx/ddy: rtol 1e-5 with atol 1e-6 against a float64
  evaluation, and atol 4e-5 against the Pallas sampler, whose bf16 hi/lo
  split dots err by up to 2⁻¹⁶·Σ|w|·max|image| (the port reads exact
  float32 taps).
- nearest: rtol 2e-5 (the Pallas probe's bf16 hi+lo image split is
  O(2⁻¹⁶) relative); the CUDA kernel and the plain version agree exactly.
- elementwise foundations: rtol 1e-5, atol 1e-6 (float32 op-order noise).
- shift plans: exact (every output lane copies one input lane), and the
  transpose is the adjoint to float32 summation noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsic3d_tpu import camera as jcam
from intrinsic3d_tpu import mathutil as jmath
from intrinsic3d_tpu.grid import ops as jgops
from intrinsic3d_tpu.grid.blocks import BlockLayout as JBlockLayout
from intrinsic3d_tpu.lighting import sh as jsh
from intrinsic3d_tpu.observations import observation_weight as j_observation_weight
from intrinsic3d_tpu.ops.pallas import bicubic as jbic
from intrinsic3d_tpu.refine import blockform as jbf
from intrinsic3d_tpu.synthetic import build_sphere_problem as j_build_sphere_problem

from intrinsic3d_torch import camera, color, mathutil
from intrinsic3d_torch.convert import grid_from_numpy
from intrinsic3d_torch.grid import ops as gops
from intrinsic3d_torch.grid.blocks import BlockLayout, pad_flat
from intrinsic3d_torch.lighting import sh
from intrinsic3d_torch.observations import observation_weight
from intrinsic3d_torch.ops import bicubic
from intrinsic3d_torch.refine import blockform

from torch_support import one_torch_thread, tensor  # noqa: F401


def _rows_problem(seed=3, k=3, h=48, w=64, chunks_per_frame=2):
    """Frame-uniform 512-element chunks (the Pallas windowed contract), with
    coordinates reaching past both clip bounds."""
    rng = np.random.default_rng(seed)
    m = k * chunks_per_frame * 512
    images = rng.uniform(0.0, 1.0, (k, h, w)).astype(np.float32)
    fid = np.repeat(np.arange(k, dtype=np.int32), chunks_per_frame * 512)
    x = rng.uniform(-2.0, w + 1.0, m).astype(np.float32)
    y = rng.uniform(-2.0, h + 1.0, m).astype(np.float32)
    active = (rng.uniform(size=m) < 0.6).astype(np.float32)
    return images, fid, x, y, active


# ---------------------------------------------------------------------------
# K1: bicubic_rows ↔ bicubic_sample_rows
# ---------------------------------------------------------------------------


def test_bicubic_rows_plain_matches_pallas():
    images, fid, x, y, active = _rows_problem()
    args = tuple(jnp.asarray(a) for a in (images, fid, x, y, active))

    val_j, vjp = jax.vjp(lambda xx, yy: jbic.bicubic_sample_rows(args[0], args[1], xx, yy, args[4]), args[2], args[3])
    ddx_j, ddy_j = vjp(jnp.ones_like(val_j))
    val, ddx, ddy = bicubic.bicubic_rows_plain(tensor(images), tensor(fid, torch.int32), tensor(x), tensor(y),
                                               tensor(active))
    exact = bicubic.bicubic_rows_plain(
        torch.as_tensor(images, dtype=torch.float64), tensor(fid, torch.int32),
        torch.as_tensor(x, dtype=torch.float64), torch.as_tensor(y, dtype=torch.float64), tensor(active),
    )
    for got, want, ref in zip((val, ddx, ddy), (val_j, ddx_j, ddy_j), exact):
        # the port's float32 taps against the float64 evaluation
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
        # against the Pallas sampler: its bf16 hi/lo split dots err by up to
        # 2⁻¹⁶·Σ|w|·max|image| against float64 (about 2e-5 on these
        # unit-range images, where the port is held to 1e-6 above) — ROADMAP
        # "Faults found in the port"
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=4e-5)
    # inactive elements are 0 with zero derivatives
    off = active == 0
    assert np.all(val.numpy()[off] == 0) and np.all(ddx.numpy()[off] == 0)


def test_bicubic_rows_autograd_is_the_derivative_output():
    images, fid, x, y, active = _rows_problem(seed=5)
    xt = tensor(x).requires_grad_(True)
    yt = tensor(y).requires_grad_(True)
    out = bicubic.bicubic_rows(tensor(images), tensor(fid, torch.int32), xt, yt, tensor(active))
    g = torch.as_tensor(np.random.default_rng(6).normal(size=x.shape).astype(np.float32))
    gx, gy = torch.autograd.grad(out, (xt, yt), grad_outputs=g)
    val, ddx, ddy = bicubic.bicubic_rows_plain(tensor(images), tensor(fid, torch.int32), tensor(x), tensor(y),
                                               tensor(active))
    torch.testing.assert_close(out.detach(), val, rtol=0, atol=0)
    torch.testing.assert_close(gx, g * ddx, rtol=0, atol=0)
    torch.testing.assert_close(gy, g * ddy, rtol=0, atol=0)
    # the CPU path never counts a kernel launch
    assert bicubic.LAUNCHES["bicubic_rows_fwdgrad"] == 0


def test_bicubic_rows_plain_matches_central_difference():
    """ddx/ddy are the derivatives of the value inside the clip range."""
    images, fid, x, y, _ = _rows_problem(seed=9)
    images64 = torch.as_tensor(images, dtype=torch.float64)
    h, w = images.shape[1:]
    xt = torch.as_tensor(np.clip(x, 1.5, w - 3.0), dtype=torch.float64)
    yt = torch.as_tensor(np.clip(y, 1.5, h - 3.0), dtype=torch.float64)
    act = torch.ones_like(xt)
    f = tensor(fid, torch.int32)
    eps = 1e-6
    _, ddx, ddy = bicubic.bicubic_rows_plain(images64, f, xt, yt, act)
    fx = (bicubic.bicubic_rows_plain(images64, f, xt + eps, yt, act)[0]
          - bicubic.bicubic_rows_plain(images64, f, xt - eps, yt, act)[0]) / (2 * eps)
    fy = (bicubic.bicubic_rows_plain(images64, f, xt, yt + eps, act)[0]
          - bicubic.bicubic_rows_plain(images64, f, xt, yt - eps, act)[0]) / (2 * eps)
    np.testing.assert_allclose(ddx.numpy(), fx.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ddy.numpy(), fy.numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# K2: nearest_rows ↔ nearest_sample_rows
# ---------------------------------------------------------------------------


def test_nearest_rows_plain_matches_pallas():
    rng = np.random.default_rng(11)
    k, h, w = 3, 48, 64
    m = k * 2 * 512
    depths = rng.uniform(0.3, 5.0, (k, h, w)).astype(np.float32)
    fid = np.repeat(np.arange(k, dtype=np.int32), 2 * 512)
    yi = rng.integers(0, h, m).astype(np.int32)
    xi = rng.integers(0, w, m).astype(np.int32)
    active = (rng.uniform(size=m) < 0.5).astype(np.float32)
    want = jbic.nearest_sample_rows(*(jnp.asarray(a) for a in (depths, fid, yi, xi, active)))
    ints = [tensor(a, torch.int32) for a in (fid, yi, xi)]
    got = bicubic.nearest_rows(tensor(depths), *ints, tensor(active))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=0)
    exact = depths[fid, yi, xi] * (active > 0)
    np.testing.assert_array_equal(got.numpy(), exact)


# ---------------------------------------------------------------------------
# K1a and K2 on ragged lengths and inactive runs: the contract the CUDA
# kernels' element streams must meet (vector groups, a scalar tail,
# skipped all-inactive groups), pinned on the plain versions
# ---------------------------------------------------------------------------

RAGGED_CASES = [(m, "runs") for m in (1, 3, 4, 5, 511, 512, 513, 1539)] + [(5, "none"), (1539, "none")]


def _ragged_problem(m, pattern, seed, k=3, h=48, w=64):
    """`m` elements frame-major in 512-element chunks (the Pallas contract);
    `pattern` "runs": the second chunk wholly inactive and 60% of the rest
    active, "none": every element inactive. Coordinates reach past both
    clip bounds."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0.3, 5.0, (k, h, w)).astype(np.float32)
    fid = (np.arange(m) // 512 % k).astype(np.int32)
    x = rng.uniform(-2.0, w + 1.0, m).astype(np.float32)
    y = rng.uniform(-2.0, h + 1.0, m).astype(np.float32)
    active = (rng.uniform(size=m) < 0.6).astype(np.float32)
    active[512:1024] = 0.0
    if pattern == "none":
        active[:] = 0.0
    return images, fid, x, y, active


def _pad_chunks(m, *arrays):
    """The arrays padded to whole 512-element chunks (the JAX sampler's
    callers pad; pad elements repeat the last frame id and are inactive)."""
    pad = -(-m // 512) * 512 - m
    return [np.concatenate([a, np.full(pad, a[-1] if i == 0 else 0, a.dtype)]) for i, a in enumerate(arrays)]


@pytest.mark.parametrize("m,pattern", RAGGED_CASES)
def test_bicubic_value_plain_matches_pallas_on_ragged_lengths(m, pattern):
    images, fid, x, y, active = _ragged_problem(m, pattern, seed=m)
    padded = _pad_chunks(m, fid, x, y, active)
    want = np.asarray(jbic.bicubic_sample_rows(jnp.asarray(images), *(jnp.asarray(a) for a in padded)))[:m]
    got = bicubic.bicubic_rows(tensor(images), tensor(fid, torch.int32), tensor(x), tensor(y), tensor(active))
    assert got.shape == (m,)
    # the Pallas sampler's bf16 hi/lo split dots (as in
    # test_bicubic_rows_plain_matches_pallas), on images up to 5
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-4)
    assert np.all(got.numpy()[active == 0] == 0)


@pytest.mark.parametrize("m,pattern", RAGGED_CASES)
def test_bicubic_fwdgrad_plain_matches_pallas_on_ragged_lengths(m, pattern):
    """The value, ddx and ddy (K1b's outputs) against `jax.vjp` of the Pallas
    sampler with a unit cotangent, on the chunk-padded arrays."""
    images, fid, x, y, active = _ragged_problem(m, pattern, seed=200 + m)
    jf, jx, jy, ja = (jnp.asarray(a) for a in _pad_chunks(m, fid, x, y, active))
    val_j, vjp = jax.vjp(lambda xx, yy: jbic.bicubic_sample_rows(jnp.asarray(images), jf, xx, yy, ja), jx, jy)
    want = (val_j, *vjp(jnp.ones_like(val_j)))
    got = bicubic.bicubic_rows_plain(tensor(images), tensor(fid, torch.int32), tensor(x), tensor(y), tensor(active))
    # the value's tolerance (test_bicubic_value_plain_matches_pallas_on_ragged_lengths:
    # the Pallas bf16 hi/lo split dots on images up to 5); the derivatives'
    # absolute error scales with their weights' sum Σ|dw_x|·Σ|w_y| <= 3 x
    # 1.25, against the value's Σ|w_x|·Σ|w_y| <= 1.25 x 1.25
    for name, g, w, atol in zip(("value", "ddx", "ddy"), got, want, (2e-4, 2e-4 * 3 / 1.25, 2e-4 * 3 / 1.25)):
        assert g.shape == (m,), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:m], rtol=1e-5, atol=atol, err_msg=name)
        assert np.all(g.numpy()[active == 0] == 0), name


@pytest.mark.parametrize("m,pattern", RAGGED_CASES)
def test_nearest_rows_plain_matches_pallas_on_ragged_lengths(m, pattern):
    images, fid, x, y, active = _ragged_problem(m, pattern, seed=100 + m)
    h, w = images.shape[1:]
    yi = np.clip(np.floor(y + 0.5), 0, h - 1).astype(np.int32)
    xi = np.clip(np.floor(x + 0.5), 0, w - 1).astype(np.int32)
    want = jbic.nearest_sample_rows(*(jnp.asarray(a) for a in (images, fid, yi, xi, active)))
    got = bicubic.nearest_rows(tensor(images), *(tensor(a, torch.int32) for a in (fid, yi, xi)), tensor(active))
    assert got.shape == (m,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=0)
    np.testing.assert_array_equal(got.numpy(), images[fid, yi, xi] * (active > 0))


# ---------------------------------------------------------------------------
# Elementwise foundations
# ---------------------------------------------------------------------------


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("scale", [1e-8, 1e-3, 1.0, 3.0])
def test_rotate_and_transform_points(scale):
    rng = np.random.default_rng(21)
    aa = (rng.normal(size=(64, 3)) * scale).astype(np.float32)
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    trans = rng.normal(size=(64, 3)).astype(np.float32)
    want = jax.vmap(jmath.rotate_angle_axis)(jnp.asarray(aa), jnp.asarray(pts))
    _close(mathutil.rotate_angle_axis(tensor(aa), tensor(pts)), want)
    pose = np.concatenate([aa, trans], axis=-1)
    want_t = jax.vmap(jmath.transform_points)(jnp.asarray(pose), jnp.asarray(pts))
    _close(mathutil.transform_points(tensor(pose), tensor(pts)), want_t)


def test_pose_conversions_and_weights():
    rng = np.random.default_rng(22)
    for _ in range(5):
        pose = rng.normal(size=6)
        m_t, m_j = mathutil.pose_vec_to_matrix(pose), jmath.pose_vec_to_matrix(pose)
        np.testing.assert_array_equal(m_t, m_j)
        np.testing.assert_array_equal(mathutil.pose_matrix_to_vec(m_t), jmath.pose_matrix_to_vec(m_j))
        np.testing.assert_array_equal(mathutil.invert_pose(m_t), jmath.invert_pose(m_j))
    x = rng.uniform(-0.1, 1.0, 100).astype(np.float32)
    _close(mathutil.robust_kernel(tensor(x)), jmath.robust_kernel(jnp.asarray(x)))
    _close(mathutil.sdf_to_weight(tensor(x), 0.05), jmath.sdf_to_weight(jnp.asarray(x), 0.05))
    rgb = rng.uniform(0, 255, (10, 3)).astype(np.float32)
    from intrinsic3d_tpu.color import intensity as j_intensity

    _close(color.intensity(tensor(rgb)), j_intensity(jnp.asarray(rgb)))


def test_camera_distort_and_project():
    rng = np.random.default_rng(23)
    dist = np.array([0.1, -0.05, 0.01, 0.002, -0.001], np.float32)
    pts = np.concatenate(
        [rng.uniform(-0.4, 0.4, (200, 2)), rng.uniform(-0.1, 2.0, (200, 1))], axis=-1
    ).astype(np.float32)
    jc = jcam.Camera.create(70.4, 70.4, 31.5, 23.5, 64, 48, dist=dist)
    tc = camera.Camera(*(torch.tensor(v) for v in (70.4, 70.4, 31.5, 23.5)), 64, 48, tensor(dist))
    uv_j, ok_j = jcam.project(jc, jnp.asarray(pts))
    uv_t, ok_t = camera.project(tc, tensor(pts))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    _close(uv_t, uv_j, rtol=1e-5, atol=1e-4)
    xd_j = jcam.distort(jnp.asarray(dist), jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]))
    xd_t = camera.distort(tensor(dist), tensor(pts[:, 0]), tensor(pts[:, 1]))
    for a, b in zip(xd_t, xd_j):
        _close(a, b)


def test_sh_normal_and_observation_weight():
    rng = np.random.default_rng(24)
    n = rng.normal(size=(300, 3)).astype(np.float32)
    _close(sh.sh_basis(tensor(n)), jsh.sh_basis(jnp.asarray(n)))
    sdf4 = rng.normal(0, 0.01, (300, 4)).astype(np.float32)
    sdf4[:5] = 0.25  # vanishing forward difference: the +1e-24 guard
    _close(gops.compute_normal_from_sdf4(tensor(sdf4)), jgops.compute_normal_from_sdf4(jnp.asarray(sdf4)))
    # the reverse pass stays finite where the difference vanishes
    s = tensor(sdf4).requires_grad_(True)
    (g,) = torch.autograd.grad(gops.compute_normal_from_sdf4(s).sum(), s)
    assert torch.isfinite(g).all()
    pt = rng.normal(size=(300, 3)).astype(np.float32)
    nc = n / np.linalg.norm(n, axis=-1, keepdims=True)
    nc[:3] = 0.0
    d = rng.uniform(0.0, 6.0, 300).astype(np.float32)
    _close(observation_weight(tensor(pt), tensor(nc), tensor(d)),
           j_observation_weight(jnp.asarray(pt), jnp.asarray(nc), jnp.asarray(d)))


# ---------------------------------------------------------------------------
# Block layout and shift plans
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sphere_grid():
    prob = j_build_sphere_problem(voxel_size=0.02, image_size=(32, 24), num_frames=2)
    g = prob.grid
    return g, grid_from_numpy(g.voxel_size, g.coords, g.sdf, g.weight, g.color, g.albedo, g.sdf_refined)


@pytest.mark.parametrize("block", [4, 8])
def test_shift_plans_match_jax_and_are_adjoint(sphere_grid, block):
    jgrid, tgrid = sphere_grid
    jl = JBlockLayout.build(jgrid, block=block)
    tl = BlockLayout.build(tgrid, block=block)
    np.testing.assert_array_equal(tl.vox_slot, jl.vox_slot)
    np.testing.assert_array_equal(tl.nbr27, jl.nbr27)
    rng = np.random.default_rng(25)
    for jplan, tplan in zip(jbf.layout_plans(jl), blockform.layout_plans(tl, "cpu")):
        nb, s = tl.num_blocks, block**3
        field = pad_flat(tensor(rng.normal(size=(nb, s)).astype(np.float32)))
        got = tplan.apply(field)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jplan.apply(jnp.asarray(field.numpy()))))
        cot = rng.normal(size=got.shape).astype(np.float32)
        back = tplan.apply_transpose(tensor(cot))
        want = np.asarray(jplan.apply_transpose(jnp.asarray(cot)))
        # real rows: exact up to summation order; the pad row is the sink of
        # absent neighbours (never read downstream)
        np.testing.assert_allclose(back.numpy()[:-1], want[:-1], rtol=1e-6, atol=1e-6)
        # adjointness ⟨Ax, y⟩ = ⟨x, Aᵀy⟩, in float64 so only rounding remains
        cot64 = torch.as_tensor(cot, dtype=torch.float64)
        lhs = float(torch.sum(tplan.apply(field.double()) * cot64))
        rhs = float(torch.sum(field.double() * tplan.apply_transpose(cot64)))
        assert lhs == pytest.approx(rhs, rel=1e-12, abs=1e-12)
