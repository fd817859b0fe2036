"""The E_g element pass (`ops/eg_rows.py`, the card's `csrc/eg_rows.cu`)
against the eager E_g path of the block solve on the CPU.

`eg_rows_plain` is the per-element function the kernel computes, in its flat
element layout; run through the same chunking and field writes the card
runs (`blockform._eg_fused_lin`, `blockform._eg_fused_cost`, which on CPU
tensors take the plain version), it must give `_eg_reverse`'s autograd
residuals and coefficients and `block_total_cost`'s E_g cost. Cases: a dense
and a frame-bucketed assembly (with pad bucket rows, at pyramid scale 0.5),
one and three frame chunks, float32 and bfloat16 coefficient fields, and a
dense assembly of a capture rendered through a distorted lens, evaluated at
that lens and at intrinsics moved off the rendering pinhole; the
evaluation point moves one camera into the sphere, so that active elements
have points at z ≤ 1e-6 and outside the bicubic support beside valid ones,
and inactive elements make up most of the grid. Bounds: residuals rtol 1e-5;
coefficients within 1e-5 × each field's largest magnitude (compared in
float64); bfloat16 fields within one bfloat16 ulp of that.

This file imports torch and numpy only (no JAX); ~10 s on one worker.
"""

import numpy as np
import pytest
import torch

from intrinsic3d_torch.camera import distort
from intrinsic3d_torch.mathutil import transform_points
from intrinsic3d_torch.ops import build, eg_rows
from intrinsic3d_torch.refine import blockform
from intrinsic3d_torch.refine.optimizer import _bmap_on
from intrinsic3d_torch.synthetic import DEFAULT_CENTER, build_sphere_problem

from torch_support import one_torch_thread  # noqa: F401

FIELD_NAMES = ("a_sdf", "a_alb", "a_pose", "a_intr", "a_dist")
# the lens of tests/test_pose_refinement.py::test_distortion_recovery (k1 k2 k3 p1 p2)
LENS = (0.08, -0.04, 0.0, 0.10, -0.06)


def _sphere(dist=None):
    """The 5-frame sphere on the CPU (rendered through `dist`): its level
    and its dense assembly at the start point."""
    prob = build_sphere_problem(voxel_size=0.02, image_size=(64, 48), num_frames=5, num_observations=3,
                                perturb_sdf=0.002, perturb_albedo=0.05, dist=dist, device="cpu")
    level = prob.level()
    return prob, level, level.assemble(level.params, prob.depths, prob.images)[0]


def _into_the_sphere(params):
    """`params` with frame 0's camera moved to the sphere's centre."""
    poses = params.poses.clone()
    centre = torch.as_tensor(DEFAULT_CENTER, dtype=torch.float32)
    poses[0, 5] -= float(transform_points(poses[0], centre)[2])
    return params._replace(poses=poses)


@pytest.fixture(scope="module")
def scene():
    """(assembly, candidate point) of each case: the sphere's dense and
    bucketed assemblies at the start point with a candidate whose frame 0
    sits at the sphere's centre (half its elements behind the camera, most
    of the rest outside the image); the lens-rendered sphere's dense
    assembly with the same move of frame 0, at the lens, and the candidate's
    intrinsics off the pinhole (focal lengths x 1.005, principal point
    +1.5, -1.0 px)."""
    prob, level, dense = _sphere()
    fb = blockform.build_frame_buckets(level.layout, prob.params.poses.numpy(), prob.params.intr.numpy(), 64, 48,
                                       prob.grid.voxel_size, depths=prob.depths.numpy(), occlusion=0.02)
    bucketed, _ = level._replace(bmap=_bmap_on(fb, torch.device("cpu"))).assemble(level.params, prob.depths,
                                                                                  prob.images)
    bucketed = bucketed._replace(pyr_scale=torch.tensor(0.5))  # a coarser pyramid level's projection
    cand = _into_the_sphere(level.params)
    _, lens_level, lens = _sphere(LENS)
    lens_cand = _into_the_sphere(lens_level.params)
    intr = lens_cand.intr * torch.tensor([1.005, 1.005, 1.0, 1.0]) + torch.tensor([0.0, 0.0, 1.5, -1.0])
    lens_cand = lens_cand._replace(intr=intr)
    return dict(dense=(dense, cand), bucketed=(bucketed, cand), lens=(lens, lens_cand))


def _categories(asm, params):
    """Active elements with the voxel centre behind frame's camera (z ≤
    1e-6), in front but projecting outside the image, and inside it."""
    k, kb, s = asm.eg_w.shape
    act = asm.eg_w.reshape(k, -1) > 0
    if asm.bmap is None:
        slots = torch.arange(kb * s).expand(k, -1)
    else:
        slots = (asm.bmap.unsqueeze(-1) * s + torch.arange(s)).reshape(k, -1)
    pts = asm.eg_vpos.T.to(torch.float32)[torch.clamp(slots, max=asm.eg_vpos.shape[1] - 1)] * asm.voxel_size
    pc = transform_points(params.poses.view(k, 1, 6), pts)
    z = pc[..., 2]
    zs = torch.where(z > 1e-6, z, torch.ones_like(z))
    fx, fy, cx, cy = params.intr * asm.pyr_scale
    xd, yd = distort(params.dist, pc[..., 0] / zs, pc[..., 1] / zs)
    u = fx * xd + cx
    v = fy * yd + cy
    inside = (u >= 1) & (u < 62) & (v >= 1) & (v < 46)
    return (int((act & (z <= 1e-6)).sum()), int((act & (z > 1e-6) & ~inside).sum()),
            int((act & (z > 1e-6) & inside).sum()))


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at |x| (float64; the smallest normal's below it)."""
    e = torch.floor(torch.log2(torch.clamp(x.abs(), min=2.0**-126)))
    return torch.pow(2.0, e - 7)


@pytest.fixture(scope="module")
def eager():
    """`eager(key, fn)`: `fn()`, the eager path's value, computed for the
    first case that asks for `key` and kept for the others (the float32
    linearization is both a float32 case's reference and a bfloat16 case's
    exact fields; the cost and residuals do not depend on the dtype)."""
    runs = {}

    def get(key, fn):
        if key not in runs:
            runs[key] = fn()
        return runs[key]

    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("layout", ["dense", "bucketed", "lens"])
def test_eg_pass_matches_the_eager_path(scene, eager, layout, chunks, dtype):
    asm, params = scene[layout]
    if layout == "lens":
        # a nonzero lens, and intrinsics off the pinhole the frames were rendered through
        assert int((params.dist != 0).sum()) == 4 and bool((params.intr != scene["dense"][1].intr).all())
    cdt = getattr(torch, dtype)
    k, kb, s = asm.eg_w.shape
    behind, outside, inside = _categories(asm, params)
    assert behind > 100 and outside > 100 and inside > 1000, (behind, outside, inside)
    assert int((asm.eg_w > 0).sum()) < 0.2 * asm.eg_w.numel()
    if layout == "bucketed":
        assert kb < asm.er_w.shape[0] and bool((asm.bmap == asm.er_w.shape[0]).any())  # pad bucket rows

    # the linearization: the kernel's chunks and field writes, the plain
    # element function, against the eager autograd pass
    _, want = eager(("lin", layout, chunks, dtype), lambda: blockform.linearize_block_chunked(params, asm, chunks, cdt))
    sh = asm.sdf_plan.apply(params.sdf)
    sha = asm.alb_plan.apply(params.albedo)
    build.reset_launches()
    r0, coeffs = blockform._eg_fused_lin(asm, sh, sha, params, chunks, cdt)
    assert all(n == 0 for n in build.LAUNCHES.values())
    torch.testing.assert_close(r0, want.r0_g, rtol=1e-5, atol=0.0)
    assert int((r0 != 0).sum()) > 1000
    _, exact = eager(("lin", layout, chunks, "float32"),
                     lambda: blockform.linearize_block_chunked(params, asm, chunks, torch.float32))
    for name, got in zip(FIELD_NAMES, coeffs):
        ref = getattr(exact, name).double()
        tol = 1e-5 * float(ref.abs().max())
        assert got.dtype == cdt and tuple(got.shape) == tuple(ref.shape)
        if dtype == "float32":
            err = (got.double() - ref).abs()
        else:
            # the cast of the plain float32 fields, held to the eager cast
            err = (got.double() - getattr(want, name).double()).abs() - _bf16_ulp(ref)
        assert float(err.max()) <= tol, (name, float(err.max()), tol)

    # the acceptance cost: the plain residuals and partial sums against the
    # eager forward, E_g alone (the other terms' λ̃ zeroed)
    asm_g = asm._replace(lam=asm.lam * torch.tensor([1.0, 0.0, 0.0, 0.0]))
    want_cost = eager(("cost", layout, chunks), lambda: blockform.block_total_cost(params, asm_g, chunks))
    got_cost = 0.5 * blockform._eg_fused_cost(asm_g, sh, sha, params, chunks)
    torch.testing.assert_close(got_cost, want_cost, rtol=1e-5, atol=0.0)
    x = blockform._eg_inputs(asm, sh, sha, params)
    r_rows = torch.cat([eg_rows.eg_rows_value(x, asm.eg_w[lo:lo + n], lo)[0]
                        for lo, n in blockform._frame_chunks(k, chunks)])
    r_eager = eager(("residuals", layout),
                    lambda: blockform.block_all_residuals(params, asm)[: asm.eg_w.numel()].view(k, kb, s))
    torch.testing.assert_close(r_rows, r_eager, rtol=1e-5, atol=0.0)


def test_partial_sums_are_per_block_of_1024_elements():
    r = torch.arange(1, 2050, dtype=torch.float32)  # 2,049 elements: two whole blocks and a tail
    part = eg_rows._value_partials(r)
    assert part.shape == (eg_rows.partial_blocks(2049),) == (3,)
    torch.testing.assert_close(part, torch.stack([(r[:1024] ** 2).sum(), (r[1024:2048] ** 2).sum(), r[2048] ** 2]))
    assert eg_rows.partial_blocks(1024) == 2 and eg_rows.partial_blocks(0) == 1


def test_cpu_level_solve_stays_eager(scene):
    """On CPU tensors the linearization and the acceptance cost take the
    eager path, one pass a chunk, and launch nothing."""
    asm, params = scene["dense"]
    before = dict(blockform.EG_PASSES)
    build.reset_launches()
    blockform.linearize_block_chunked(params, asm, 3, torch.bfloat16)
    blockform.block_total_cost(params, asm, 3)
    blockform.block_total_cost(params, asm, 1)
    assert all(n == 0 for n in build.LAUNCHES.values())
    assert blockform.EG_PASSES["fused"] == before["fused"]
    assert blockform.EG_PASSES["eager"] == before["eager"] + 3 + 3 + 1


def test_kernel_wrappers_refuse_mismatched_inputs(scene):
    asm, params = scene["dense"]
    sh = asm.sdf_plan.apply(params.sdf)
    sha = asm.alb_plan.apply(params.albedo)
    x = blockform._eg_inputs(asm, sh, sha, params)
    k = asm.eg_w.shape[0]
    r0 = asm.eg_w.new_empty(asm.eg_w.shape)
    coeffs = [asm.eg_w.new_empty((f, *asm.eg_w.shape)) for f in eg_rows.FIELDS]
    with pytest.raises(ValueError):
        eg_rows.eg_rows_lin(x, asm.eg_w[1:], 0, r0, coeffs[:4] + [coeffs[4].to(torch.bfloat16)])
    with pytest.raises(ValueError):
        eg_rows.eg_rows_lin(x, asm.eg_w[:2], k - 1, r0, coeffs)
    with pytest.raises(ValueError):
        eg_rows.eg_rows_value(x._replace(vpos=x.vpos.to(torch.int64)), asm.eg_w, 0)
    with pytest.raises(ValueError):
        eg_rows.eg_rows_value(x, asm.eg_w, 0, partial=asm.eg_w.new_empty(3))
    np.testing.assert_array_equal(eg_rows.FIELDS, (10, 4, 6, 4, 5))
