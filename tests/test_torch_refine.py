"""Port parity of the refinement modules: residuals, block linearization,
device assembly and the damped-GN step, against `intrinsic3d_tpu` on the CPU.

Both sides start from the same arrays (`intrinsic3d_torch.convert` builds
the port's objects from the JAX package's numpy fields). Tolerances:

- `linearize_block` fields: relative error in norm ≤ 1e-4, and elementwise
  within 1e-3 of the field's largest magnitude. The JAX sampler's bf16 hi/lo
  split errs by up to ~2e-5 in the image derivative, which the projection
  Jacobian (∂u/∂sdf ~ focal/(z·voxel)) scales up on single elements
  (measured: 6.7e-5 in norm, 1.4e-4 of the field's scale at worst).
- products on the same coefficient fields (`jv_block`, `jtv_block`,
  `diag_from_lin`, `global_gram`, `jg_apply`, `jgt_apply`): rtol 1e-4 with
  an absolute floor of 1e-4 × the output's largest magnitude (summation
  order only).
- `device_assembly`: masks exact; `eg_w` equal except on at most 1% of the
  active elements (occlusion flips: the JAX depth probe carries an O(2⁻¹⁶)
  relative depth error near the 0.02 m gate); `lam` rtol 1e-4.
- `gn_iteration` with float32 coefficients on identical assembly inputs:
  cost0, cost1 and μ' rtol 1e-4, tries equal, parameters within
  `tests/test_schur.py`'s tolerances, at that file's converged-solve
  settings. (At the production budget of 12 CG steps the inexact solve
  passes the sampler noise on: μ' then differs by 1.3e-4, since Ceres'
  update μ·(1−(2ρ−1)³) multiplies the noise of the gain ratio ρ by ~8.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsic3d_tpu.config import RefinementConfig as JRefinementConfig
from intrinsic3d_tpu.grid.blocks import BlockLayout as JBlockLayout
from intrinsic3d_tpu.refine import blockform as jbf
from intrinsic3d_tpu.refine.device_assembly import build_level_static as j_build_level_static
from intrinsic3d_tpu.refine.device_assembly import device_assembly as j_device_assembly
from intrinsic3d_tpu.refine.solver import gn_iteration as j_gn_iteration
from intrinsic3d_tpu.synthetic import build_sphere_problem as j_build_sphere_problem

from intrinsic3d_torch.config import RefinementConfig
from intrinsic3d_torch.convert import (
    block_assembly_from_numpy,
    grid_from_numpy,
    masks_from_numpy,
    params_from_numpy,
)
from intrinsic3d_torch.grid.blocks import BlockLayout
from intrinsic3d_torch.refine import blockform
from intrinsic3d_torch.refine.assembly import LevelTopology
from intrinsic3d_torch.refine.device_assembly import build_level_static, device_assembly
from intrinsic3d_torch.refine.optimizer import level_schur
from intrinsic3d_torch.refine.solver import gn_iteration
from intrinsic3d_torch.synthetic import build_sphere_problem


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes: one intra-op
    thread per process keeps torch from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return np.asarray(a)


def _arrays(got, want):
    got = got.detach().to(torch.float64).numpy() if torch.is_tensor(got) else np.asarray(got, np.float64)
    return got, np.asarray(want, np.float64)


def _close(got, want, rtol=1e-4):
    got, want = _arrays(got, want)
    floor = rtol * max(float(np.max(np.abs(want))) if want.size else 0.0, 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor)


def _close_in_norm(got, want, rtol=1e-4, elem=1e-3):
    got, want = _arrays(got, want)
    scale = max(float(np.linalg.norm(want)), 1e-30)
    assert np.linalg.norm(got - want) <= rtol * scale, np.linalg.norm(got - want) / scale
    np.testing.assert_allclose(got, want, rtol=elem, atol=elem * float(np.max(np.abs(want), initial=0.0)))


def _port_params(p):
    return params_from_numpy(*(_np(a) for a in p), device="cpu")


def _port_asm(layout, basm):
    return block_assembly_from_numpy(
        layout,
        *(_np(getattr(basm, f)) for f in (
            "eg_w", "eg_sh", "eg_vpos", "er_w", "es_ref", "es_w", "ea_w", "lam", "images",
            "pyr_scale", "voxel_size",
        )),
        device="cpu",
    )


def _port_grid(g):
    return grid_from_numpy(g.voxel_size, g.coords, g.sdf, g.weight, g.color, g.albedo, g.sdf_refined)


# ---------------------------------------------------------------------------
# Device-assembled problem (the production path of one outer iteration)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def assembled():
    prob = j_build_sphere_problem(
        voxel_size=0.02, image_size=(64, 48), num_frames=2, num_observations=2,
        perturb_sdf=0.002, perturb_albedo=0.05,
    )
    jl = JBlockLayout.build(prob.grid)
    jst = j_build_level_static(jl, prob.grid, prob.topo, prob.voxel_sh)
    jsp, jap = jbf.layout_plans(jl)
    bp = prob.params._replace(
        sdf=jbf.table_to_dense(jl, prob.params.sdf),
        albedo=jbf.table_to_dense(jl, prob.params.albedo),
    )
    cfg = prob.cfg
    scal = (1.0, prob.grid.voxel_size, prob.grid.truncation, prob.thres_shell, cfg.occlusion_distance)
    lams = np.asarray([cfg.lambda_g, 10.0, 10.0, cfg.lambda_a], np.float32)
    kw = dict(num_obs=2, width=64, height=48)
    basm, bm = j_device_assembly(
        jst, jsp, jap, bp, prob.depths, prob.images,
        *(jnp.float32(v) for v in scal), jnp.asarray(lams), **kw,
    )
    tgrid = _port_grid(prob.grid)
    tl = BlockLayout.build(tgrid)
    return dict(
        prob=prob, jl=jl, jst=jst, jsp=jsp, jap=jap, bp=bp, basm=basm, bm=bm, scal=scal,
        lams=lams, kw=kw, tgrid=tgrid, tl=tl, tparams=_port_params(bp), tasm=_port_asm(tl, basm),
    )


@pytest.fixture(scope="module")
def jax_lin(assembled):
    """The JAX package's linearization of the assembled problem, jitted as
    its solver runs it (eager dispatch of the interpreted Pallas calls costs
    several times the compile)."""
    return jax.jit(jbf.linearize_block)(assembled["bp"], assembled["basm"])


def test_block_residuals_match(assembled):
    a = assembled
    want = jax.jit(jbf.block_all_residuals)(a["bp"], a["basm"])
    got = blockform.block_all_residuals(a["tparams"], a["tasm"])
    _close(got, want)


def test_linearize_block_matches(assembled, jax_lin):
    a = assembled
    c_j, lin_j = jax_lin
    c_t, lin_t = blockform.linearize_block(a["tparams"], a["tasm"])
    assert float(c_t) == pytest.approx(float(c_j), rel=1e-4)
    for name in blockform.BlockLin._fields:
        _close_in_norm(getattr(lin_t, name), getattr(lin_j, name))
    assert torch.isfinite(lin_t.a_sdf).all() and torch.isfinite(lin_t.a_pose).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_products_match(assembled, jax_lin, dtype):
    """J·v, Jᵀ·y, diag(JᵀJ), the global Gram and J_g/J_gᵀ against JAX on the
    same (possibly bf16-cast) coefficient fields: JAX's linearization, cast
    on both sides (bf16 rounding is exact, so both hold identical fields)."""
    a = assembled
    _, lin_j = jax_lin
    lin_t = blockform.BlockLin(*(torch.as_tensor(np.array(f, np.float32)) for f in lin_j))
    if dtype != "float32":
        lin_j = jbf.cast_lin(lin_j, jnp.bfloat16)
        lin_t = blockform.cast_lin(lin_t, torch.bfloat16)
    rng = np.random.default_rng(31)
    v_np = [rng.normal(size=np.shape(x)).astype(np.float32) for x in a["bp"]]
    v_j = a["bp"]._replace(**{f: jnp.asarray(x) for f, x in zip(a["bp"]._fields, v_np)})
    v_t = params_from_numpy(*v_np, device="cpu")

    y_j = jbf.jv_block(lin_j, a["basm"], v_j)
    y_t = blockform.jv_block(lin_t, a["tasm"], v_t)
    for got, want in zip(y_t, y_j):
        _close(got, want)
    cot = [rng.normal(size=np.shape(t)).astype(np.float32) for t in y_j]
    g_j = jbf.jtv_block(lin_j, a["basm"], tuple(jnp.asarray(c) for c in cot))
    g_t = blockform.jtv_block(lin_t, a["tasm"], tuple(torch.as_tensor(c) for c in cot))
    for got, want in zip(g_t, g_j):
        _close(got[:-1] if got.dim() == 2 and got.shape[1] == 512 else got,
               _np(want)[:-1] if np.ndim(want) == 2 and np.shape(want)[1] == 512 else want)
    # the port's pair is adjoint
    lhs = sum(float(torch.sum(y.double() * torch.as_tensor(c, dtype=torch.float64))) for y, c in zip(y_t, cot))
    rhs = sum(float(torch.sum(v.double() * g.double())) for v, g in zip(v_t, g_t))
    assert lhs == pytest.approx(rhs, rel=1e-4)

    d_j = jbf.diag_from_lin(lin_j, a["basm"])
    d_t = blockform.diag_from_lin(lin_t, a["tasm"])
    for got, want in zip(d_t, d_j):
        _close(got, want)
    _close(blockform.global_gram(lin_t), jbf.global_gram(lin_j))
    gp, gi, gd = v_np[2], v_np[3], v_np[4]
    _close(blockform.jg_apply(lin_t, *(torch.as_tensor(x) for x in (gp, gi, gd))),
           jbf.jg_apply(lin_j, *(jnp.asarray(x) for x in (gp, gi, gd))))
    for got, want in zip(blockform.jgt_apply(lin_t, torch.as_tensor(cot[0])), jbf.jgt_apply(lin_j, jnp.asarray(cot[0]))):
        _close(got, want)


def test_level_topology_and_static_match(assembled):
    a = assembled
    topo = LevelTopology.build(a["tgrid"])
    for f in ("eg_sdf10_idx", "eg_alb4_idx", "ring6_idx", "nbr4_idx", "ea_pairs", "coords"):
        np.testing.assert_array_equal(getattr(topo, f), getattr(a["prob"].topo, f))
    st = build_level_static(a["tl"], a["tgrid"], topo, a["prob"].voxel_sh, device="cpu")
    for f in st._fields:
        np.testing.assert_array_equal(getattr(st, f).numpy(), _np(getattr(a["jst"], f)))


@pytest.mark.parametrize("min_pose_obs", [0, 10**9])
def test_device_assembly_matches(assembled, min_pose_obs):
    a = assembled
    if min_pose_obs:
        basm_j, bm_j = j_device_assembly(
            a["jst"], a["jsp"], a["jap"], a["bp"], a["prob"].depths, a["prob"].images,
            *(jnp.float32(v) for v in a["scal"]), jnp.asarray(a["lams"]), **a["kw"],
            min_pose_obs=min_pose_obs,
        )
    else:
        basm_j, bm_j = a["basm"], a["bm"]
    st = build_level_static(a["tl"], a["tgrid"], LevelTopology.build(a["tgrid"]), a["prob"].voxel_sh, device="cpu")
    sp, ap = blockform.layout_plans(a["tl"], "cpu")
    basm_t, bm_t = device_assembly(
        st, sp, ap, a["tparams"], torch.as_tensor(np.array(a["prob"].depths)),
        torch.as_tensor(np.array(a["prob"].images)), *a["scal"], torch.as_tensor(a["lams"]),
        **a["kw"], min_pose_obs=min_pose_obs, device="cpu",
    )
    for got, want in zip(bm_t, bm_j):
        np.testing.assert_array_equal(got.numpy(), _np(want))
    for f in ("er_w", "es_w", "es_ref", "ea_w", "eg_sh", "eg_vpos", "images"):
        np.testing.assert_array_equal(getattr(basm_t, f).numpy(), _np(getattr(basm_j, f)))
    w_t = basm_t.eg_w.numpy()
    w_j = _np(basm_j.eg_w)
    act = (w_t > 0) | (w_j > 0)
    flips = np.count_nonzero((w_t > 0) != (w_j > 0))
    assert act.sum() > 100 and flips <= 0.01 * act.sum(), (flips, act.sum())
    both = (w_t > 0) & (w_j > 0)
    np.testing.assert_allclose(w_t[both], w_j[both], rtol=1e-5, atol=1e-7)
    _close(basm_t.lam, basm_j.lam)


# ---------------------------------------------------------------------------
# One damped-GN step on identical assembly inputs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def schur_problem():
    """`tests/test_schur.py::block_problem`: the host assembly re-laid out in
    block form by the JAX package, handed to both solvers."""
    cfg = JRefinementConfig(
        num_observations=2, occlusion_distance=0.04, fix_poses=False, fix_intrinsics=False,
        fix_distortion=False, lambda_r0=20.0, lambda_r1=20.0, lambda_s0=20.0, lambda_s1=20.0,
        lambda_a=0.1,
    )
    prob = j_build_sphere_problem(
        voxel_size=0.015, image_size=(64, 48), num_frames=3, num_observations=2, cfg=cfg,
        perturb_sdf=0.002, perturb_albedo=0.05,
    )
    asm, masks = prob.assemble()
    jl = JBlockLayout.build(prob.grid)
    bp, basm, bm = jbf.to_block_problem(jl, prob.topo.coords, asm, masks, prob.params, num_obs=2)
    tl = BlockLayout.build(_port_grid(prob.grid))
    return bp, basm, bm, _port_params(bp), _port_asm(tl, basm), masks_from_numpy(*(_np(m) for m in bm), device="cpu")


@pytest.mark.parametrize("schur", [True, False, "poses"])
def test_gn_iteration_matches(schur_problem, schur):
    bp, basm, bm, tp, tasm, tm = schur_problem
    # test_schur.py's converged settings (heavy damping, tight forcing): both
    # branches solve far below the sampler noise, so the two implementations
    # take the same step; the port's elimination of the poses alone
    # ("poses", the camera in the PCG) solves the same damped system as
    # JAX's elimination of the whole global block
    kw = dict(lm_steps=4, cg_iters=200, cg_coeff_dtype="float32", schur_globals=schur, cg_eta=1e-8)
    jkw = dict(kw, schur_globals=bool(schur))
    p_j, c0_j, c1_j, mu_j, tr_j = j_gn_iteration(bp, basm, bm, jnp.float32(0.3), **jkw)
    p_t, c0_t, c1_t, mu_t, tr_t = gn_iteration(tp, tasm, tm, 0.3, **kw, device="cpu")
    assert tr_t == int(tr_j)
    assert float(c0_t) == pytest.approx(float(c0_j), rel=1e-4)
    assert float(c1_t) == pytest.approx(float(c1_j), rel=1e-4)
    assert float(c1_t) < float(c0_t)
    assert float(mu_t) == pytest.approx(float(mu_j), rel=1e-4)
    np.testing.assert_allclose(p_t.poses.numpy(), _np(p_j.poses), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(p_t.intr.numpy(), _np(p_j.intr), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(p_t.sdf.numpy(), _np(p_j.sdf), rtol=5e-3, atol=2e-6)
    np.testing.assert_allclose(p_t.albedo.numpy(), _np(p_j.albedo), rtol=5e-3, atol=2e-6)


def test_level_solve_keeps_a_free_camera_in_the_pcg():
    """The level driver eliminates the poses exactly and, while the camera
    is free, leaves its intrinsics and distortion to the PCG
    (`optimizer.level_schur`). One step at the production settings (12 CG
    steps, η = 0.1, μ = 1e-4) from a camera off the rendering pinhole
    (focal lengths x 1.005, principal point +1.5, -1.0 px): the step the
    level takes holds fx within 0.5% and keeps 99% of the E_g elements,
    where the whole block's exact elimination steps fx 6% further from the
    true focal length and drops 9% of them (measured: 141.50 → 141.56
    against 150.48, true 140.80; 15,610 elements → 15,585 against 14,275)."""
    free = RefinementConfig(num_observations=3, occlusion_distance=0.02)
    assert level_schur(free) == "poses"
    assert level_schur(dataclasses.replace(free, fix_intrinsics=True, fix_distortion=True)) is True
    assert level_schur(dataclasses.replace(free, fix_intrinsics=True)) == "poses"
    assert level_schur(dataclasses.replace(free, schur_globals=False)) is False
    prob = build_sphere_problem(voxel_size=0.01, image_size=(128, 96), num_frames=5, num_observations=3, cfg=free,
                                perturb_sdf=0.001, perturb_albedo=0.02, device="cpu")
    level = prob.level()
    true_fx = float(level.params.intr[0])
    p = level.params._replace(intr=level.params.intr * torch.tensor([1.005, 1.005, 1.0, 1.0])
                              + torch.tensor([0.0, 0.0, 1.5, -1.0]))
    asm, masks = level.assemble(p, prob.depths, prob.images)
    n0 = int((asm.eg_w > 0).sum())
    steps = {}
    for mode in (level_schur(free), True):
        out = gn_iteration(p, asm, masks, 1e-4, 50, 12, schur_globals=mode, cg_eta=0.1, device="cpu")
        assert out[4] == 1 and float(out[2]) < float(out[1])
        elems = int((level.assemble(out[0], prob.depths, prob.images)[0].eg_w > 0).sum())
        steps[mode] = (float(out[0].intr[0]), elems)
    fx0 = float(p.intr[0])
    assert abs(steps["poses"][0] - fx0) < 5e-3 * fx0 and steps["poses"][1] >= 0.99 * n0, steps
    assert steps[True][0] - true_fx > 0.04 * true_fx and steps[True][1] < 0.95 * n0, steps
