"""The port's frame-bucketed and streamed E_g element transport against the
JAX package and against the port's own dense layout, on the CPU.

The scene is the 3-frame sphere of `tests/test_frame_buckets.py` (voxel
15 mm, 64×48 images, 2 observations; 64 blocks, exact buckets of 56 blocks a
frame). Both packages start from the same numpy arrays; the port's objects
are built from the JAX package's fields (`intrinsic3d_torch.convert`).
Tolerances, each with its reason:
- block-row gathers (`_stencil_bucket`, `_perslot_bucket`) exact;
  `_unbucket`'s scatter-add rtol 1e-6 (the same sums in another order);
- `device_assembly(bmap=…)` against JAX: masks and the static fields exact,
  `eg_w` equal (rtol 1e-5) except on at most 1% of the active elements
  (`tests/test_torch_refine.py`: the JAX depth probe's O(2⁻¹⁶) depth error
  flips the occlusion gate), `lam` rtol 1e-4 (its sums then differ by those
  flips); against the port's dense assembly: the same active elements, the
  dense weights gathered at the buckets rtol 1e-6 (the per-frame points take
  another vectorized path: some weights one ulp apart);
- `block_all_residuals` and `linearize_block` against JAX at
  `tests/test_torch_refine.py`'s tolerances (the JAX sampler's bf16 hi/lo
  split); `jv_block`, `jtv_block` and `diag_from_lin` on JAX's own
  coefficient fields rtol 1e-5 with a floor of 1e-5 × the largest magnitude
  (float32 sums in another order);
- the bucketed layout against the port's dense one: the cost rtol 1e-6, the
  coefficient fields at the buckets rtol 1e-5 with the same floor (those
  one-ulp weights), the products rtol 1e-5;
- `linearize_block_chunked` against one-shot: bit for bit (each element is
  computed alone; chunking re-batches it), the cost rtol 1e-6;
  `block_total_cost` against the residual stack rtol 1e-6;
- `optimize_level`, bucketed and streamed, against JAX's: first cost rtol
  1e-4, the trajectories rtol 2e-2 and sdf atol 2e-3, the tolerances of
  `tests/test_eg_chunked.py` (bf16 coefficients and a 12-step PCG amplify
  rounding across relinearizations). The levels refine poses with the
  intrinsics and distortion fixed, as bench_pipeline.py does: with those free
  too, the second bf16 step of this 3-frame scene is chaotic in rounding
  (the port's own dense level lands on costs tens of percent apart at 1 and
  4 torch threads), in the dense and the bucketed layout alike.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import intrinsic3d_tpu.refine.optimizer as j_opt
from intrinsic3d_tpu.config import RefinementConfig as JRefinementConfig
from intrinsic3d_tpu.grid.blocks import BlockLayout as JBlockLayout
from intrinsic3d_tpu.refine import blockform as jbf
from intrinsic3d_tpu.refine.device_assembly import build_level_static as j_build_level_static
from intrinsic3d_tpu.refine.device_assembly import device_assembly as j_device_assembly
from intrinsic3d_tpu.synthetic import build_sphere_problem as j_build_sphere_problem

from intrinsic3d_torch.config import RefinementConfig
from intrinsic3d_torch.convert import grid_from_numpy, params_from_numpy
from intrinsic3d_torch.grid.blocks import BlockLayout
from intrinsic3d_torch.refine import blockform as bf
from intrinsic3d_torch.refine import optimizer as opt
from intrinsic3d_torch.refine.assembly import LevelTopology
from intrinsic3d_torch.refine.device_assembly import build_level_static, device_assembly

from torch_support import close, close_in_norm, one_torch_thread, to_numpy  # noqa: F401

CFG = dict(num_observations=2, occlusion_distance=0.04, fix_poses=False, fix_intrinsics=False, fix_distortion=False)
PROBLEM = dict(voxel_size=0.015, image_size=(64, 48), num_frames=3, num_observations=2, perturb_sdf=0.002,
               perturb_albedo=0.05)
LAMBDAS = np.asarray([0.2, 20.0, 20.0, 0.1], np.float32)


def _at_buckets(dense, bmap):
    """`[..., K, nb, S]` dense element values → `[..., K, NBc, S]` at the
    buckets, 0 on padding entries."""
    nb = dense.shape[-2]
    pad = torch.cat([dense, torch.zeros_like(dense[..., :1, :])], dim=-2)
    k = torch.arange(bmap.shape[0]).view(-1, 1)
    return pad[..., k, bmap, :] * (bmap < nb).unsqueeze(-1)


@pytest.fixture(scope="module")
def scene():
    """The JAX problem, its level statics and buckets, JAX's bucketed device
    assembly and linearization, and the port's dense and bucketed
    assemblies of the same arrays."""
    jcfg = JRefinementConfig(**CFG)
    prob = j_build_sphere_problem(**PROBLEM, cfg=jcfg)
    jl = JBlockLayout.build(prob.grid)
    jst = j_build_level_static(jl, prob.grid, prob.topo, prob.voxel_sh)
    jsp, jap = jbf.layout_plans(jl)
    bp = prob.params._replace(sdf=jbf.table_to_dense(jl, prob.params.sdf),
                              albedo=jbf.table_to_dense(jl, prob.params.albedo))
    thres = prob.thres_shell
    fb = jbf.build_frame_buckets(
        jl, to_numpy(prob.params.poses), to_numpy(prob.params.intr), 64, 48, prob.grid.voxel_size, margin_px=0.15 * 64,
        depths=to_numpy(prob.depths), occlusion=0.04, depth_slack=0.05 + thres,
    )
    scal = (1.0, prob.grid.voxel_size, prob.grid.truncation, thres, 0.04)
    kw = dict(num_obs=2, width=64, height=48)
    jasm, jm = j_device_assembly(jst, jsp, jap, bp, prob.depths, prob.images, *(jnp.float32(v) for v in scal),
                                 jnp.asarray(LAMBDAS), **kw, bmap=jnp.asarray(fb))
    jlin = jax.jit(jbf.linearize_block)(bp, jasm)

    g = prob.grid
    tgrid = grid_from_numpy(g.voxel_size, g.coords, g.sdf, g.weight, g.color, g.albedo, g.sdf_refined)
    tl = BlockLayout.build(tgrid)
    st = build_level_static(tl, tgrid, LevelTopology.build(tgrid), prob.voxel_sh, device="cpu")
    sp, ap = bf.layout_plans(tl, "cpu")
    tparams = params_from_numpy(*(to_numpy(a) for a in bp), device="cpu")
    bmap = torch.as_tensor(fb.astype(np.int64))
    depths, images = torch.as_tensor(np.array(prob.depths)), torch.as_tensor(np.array(prob.images))

    def assemble(b):
        return device_assembly(st, sp, ap, tparams, depths, images, *scal, torch.as_tensor(LAMBDAS), **kw,
                               bmap=b, device="cpu")

    return dict(prob=prob, jcfg=jcfg, bp=bp, fb=fb, jasm=jasm, jm=jm, jlin=jlin, tl=tl, tparams=tparams, bmap=bmap,
                dense=assemble(None), bucketed=assemble(bmap))


def test_bucket_transport_matches_jax():
    """`_stencil_bucket`, `_perslot_bucket` and `_unbucket` on seeded arrays,
    with padding entries and blocks shared between frames."""
    rng = np.random.default_rng(5)
    nb, s, k, nbc = 12, 512, 4, 7
    bmap = np.stack([np.sort(rng.choice(nb, nbc - 2, replace=False)) for _ in range(k)])
    bmap = np.concatenate([bmap, np.full((k, 2), nb)], axis=1).astype(np.int32)
    jb, tb = jnp.asarray(bmap), torch.as_tensor(bmap.astype(np.int64))
    sh = rng.normal(size=(13, nb, s)).astype(np.float32)
    field = rng.normal(size=(9, nb * s)).astype(np.float32)
    vals = rng.normal(size=(10, k, nbc, s)).astype(np.float32)
    np.testing.assert_array_equal(bf._stencil_bucket(torch.as_tensor(sh), 10, tb).numpy(),
                                  to_numpy(jbf._stencil_bucket(jnp.asarray(sh), 10, jb)))
    np.testing.assert_array_equal(bf._perslot_bucket(torch.as_tensor(field), tb, s).numpy(),
                                  to_numpy(jbf._perslot_bucket(jnp.asarray(field), jb, s)))
    got = bf._unbucket(torch.as_tensor(vals), tb, nb, s)
    want = jbf._unbucket(jnp.asarray(vals), jb, nb, s)
    assert got.shape == (10, nb, s)
    np.testing.assert_allclose(got.numpy(), to_numpy(want), rtol=1e-6, atol=1e-6)


def test_bucketed_device_assembly_matches(scene):
    """Every field and mask against JAX's bucketed assembly, and the weights
    against the port's dense assembly gathered at the buckets."""
    (asm, masks), (dasm, dmasks) = scene["bucketed"], scene["dense"]
    jasm, jm = scene["jasm"], scene["jm"]
    for got, want in zip(masks, jm):
        np.testing.assert_array_equal(got.numpy(), to_numpy(want))
    for f in ("er_w", "es_w", "es_ref", "ea_w", "eg_sh", "eg_vpos", "images"):
        np.testing.assert_array_equal(getattr(asm, f).numpy(), to_numpy(getattr(jasm, f)))
    np.testing.assert_array_equal(asm.bmap.numpy(), scene["fb"])
    w_t, w_j = asm.eg_w.numpy(), to_numpy(jasm.eg_w)
    assert w_t.shape == w_j.shape == (3, scene["fb"].shape[1], 512)
    act = (w_t > 0) | (w_j > 0)
    flips = np.count_nonzero((w_t > 0) != (w_j > 0))
    assert act.sum() > 1000 and flips <= 0.01 * act.sum(), (flips, act.sum())
    both = (w_t > 0) & (w_j > 0)
    np.testing.assert_allclose(w_t[both], w_j[both], rtol=1e-5, atol=1e-7)
    close(asm.lam, jasm.lam, rtol=1e-4)

    for got, want in zip(masks, dmasks):
        assert torch.equal(got, want)
    want = _at_buckets(dasm.eg_w, scene["bmap"])
    assert torch.equal(asm.eg_w > 0, want > 0)
    torch.testing.assert_close(asm.eg_w, want, rtol=1e-6, atol=0)
    torch.testing.assert_close(asm.lam, dasm.lam, rtol=1e-6, atol=0)


def test_bucketed_residuals_and_linearization_match(scene):
    asm, _ = scene["bucketed"]
    dasm, _ = scene["dense"]
    p, bmap = scene["tparams"], scene["bmap"]
    r_t = bf.block_all_residuals(p, asm)
    r_j = jax.jit(jbf.block_all_residuals)(scene["bp"], scene["jasm"])
    close(r_t, r_j, rtol=1e-4)
    r_d = bf.block_all_residuals(p, dasm)
    assert float(torch.sum(r_t * r_t)) == pytest.approx(float(torch.sum(r_d * r_d)), rel=1e-6)

    c_t, lin_t = bf.linearize_block(p, asm)
    c_j, lin_j = scene["jlin"]
    assert float(c_t) == pytest.approx(float(c_j), rel=1e-4)
    for name in bf.BlockLin._fields:
        close_in_norm(getattr(lin_t, name), getattr(lin_j, name))
    c_d, lin_d = bf.linearize_block(p, dasm)
    assert float(c_t) == pytest.approx(float(c_d), rel=1e-6)
    for name in ("a_sdf", "a_alb", "a_pose", "a_intr", "a_dist", "r0_g"):
        close(getattr(lin_t, name), _at_buckets(getattr(lin_d, name), bmap), 1e-5)
    for name in ("r0_r", "r0_s", "r0_a", "sq_er", "sq_es", "sq_ea"):
        close(getattr(lin_t, name), getattr(lin_d, name), 1e-5)


def test_bucketed_products_match(scene):
    """J·v, Jᵀ·y and diag(JᵀJ) on JAX's bucketed coefficient fields against
    JAX's, and on the port's own bucketed and dense linearizations against
    each other (the pair stays adjoint)."""
    asm, _ = scene["bucketed"]
    dasm, _ = scene["dense"]
    bp, jasm, bmap = scene["bp"], scene["jasm"], scene["bmap"]
    _, lin_j = scene["jlin"]
    lin_t = bf.BlockLin(*(torch.as_tensor(np.array(f, np.float32)) for f in lin_j))
    rng = np.random.default_rng(17)
    v_np = [rng.normal(size=np.shape(x)).astype(np.float32) for x in bp]
    v_j = bp._replace(**{f: jnp.asarray(x) for f, x in zip(bp._fields, v_np)})
    v_t = params_from_numpy(*v_np, device="cpu")

    y_j = jbf.jv_block(lin_j, jasm, v_j)
    y_t = bf.jv_block(lin_t, asm, v_t)
    for got, want in zip(y_t, y_j):
        close(got, want, 1e-5)
    cot = [rng.normal(size=np.shape(t)).astype(np.float32) for t in y_j]
    g_j = jbf.jtv_block(lin_j, jasm, tuple(jnp.asarray(c) for c in cot))
    g_t = bf.jtv_block(lin_t, asm, tuple(torch.as_tensor(c) for c in cot))
    for got, want in zip(g_t, g_j):
        close(got, want, 1e-5)
    for got, want in zip(bf.diag_from_lin(lin_t, asm), jbf.diag_from_lin(lin_j, jasm)):
        close(got, want, 1e-5)
    lhs = sum(float(torch.sum(y.double() * torch.as_tensor(c, dtype=torch.float64))) for y, c in zip(y_t, cot))
    rhs = sum(float(torch.sum(v.double() * g.double())) for v, g in zip(v_t, g_t))
    assert lhs == pytest.approx(rhs, rel=1e-5)

    _, lin_b = bf.linearize_block(scene["tparams"], asm)
    _, lin_d = bf.linearize_block(scene["tparams"], dasm)
    y_b, y_d = bf.jv_block(lin_b, asm, v_t), bf.jv_block(lin_d, dasm, v_t)
    close(y_b[0], _at_buckets(y_d[0], bmap), 1e-5)
    for got, want in zip(y_b[1:], y_d[1:]):
        close(got, want, 1e-5)
    for got, want in zip(bf.jtv_block(lin_b, asm, y_b), bf.jtv_block(lin_d, dasm, y_d)):
        close(got, want, 1e-5)
    for got, want in zip(bf.diag_from_lin(lin_b, asm), bf.diag_from_lin(lin_d, dasm)):
        close(got, want, 1e-5)
    close(bf.global_gram(lin_b), bf.global_gram(lin_d), 1e-5)


@pytest.mark.parametrize("layout", ["dense", "bucketed"])
@pytest.mark.parametrize("chunks", [2, 3])
def test_chunked_linearization_matches_one_shot(scene, layout, chunks):
    asm, _ = scene[layout]
    p = scene["tparams"]
    c0, lin0 = bf.linearize_block(p, asm)
    c1, lin1 = bf.linearize_block_chunked(p, asm, chunks)
    assert float(c1) == pytest.approx(float(c0), rel=1e-6)
    for name in bf.BlockLin._fields:
        assert torch.equal(getattr(lin1, name), getattr(lin0, name)), name
    r = bf.block_all_residuals(p, asm)
    total = 0.5 * float(torch.sum(r.double() ** 2))
    assert float(bf.block_total_cost(p, asm, chunks)) == pytest.approx(total, rel=1e-6)
    # the streamed solve's fields: coefficients in bf16, the residual float32
    _, lin_h = bf.linearize_block_chunked(p, asm, chunks, torch.bfloat16)
    assert lin_h.a_sdf.dtype == torch.bfloat16 and lin_h.r0_g.dtype == torch.float32
    assert torch.equal(lin_h.a_pose, lin0.a_pose.to(torch.bfloat16))
    d = bf.diag_from_lin(lin_h, asm)
    assert d.sdf.dtype == torch.float32 and torch.isfinite(d.poses).all()


def _level_args(prob, cfg):
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    g = prob.grid
    grid = grid_from_numpy(g.voxel_size, g.coords, g.sdf, g.weight, g.color, g.albedo, g.sdf_refined)
    params = params_from_numpy(*(to_numpy(a) for a in prob.params), device="cpu")
    return (grid, None, params, cfg, None, t(prob.depths), t(prob.images), to_numpy(prob.voxel_sh), prob.thres_shell, 0)


def _solve_cfgs():
    kw = dict(CFG, iterations=2, lm_steps=6, frame_bucketing="always", lambda_r0=20.0, lambda_r1=20.0,
              lambda_s0=20.0, lambda_s1=20.0, fix_intrinsics=True, fix_distortion=True)
    return JRefinementConfig(**kw), RefinementConfig(**kw)


def _streaming_budget(k, nbc, chunks):
    """A budget under which the exact buckets stream in `chunks` frame chunks."""
    el = k * nbc * 512
    f_max = -(-k // chunks)
    return el * opt._EG_CHUNK_PERSIST_BYTES + (f_max + 0.5) * nbc * 512 * opt._EG_CHUNK_TRANSIENT_BYTES


@pytest.mark.parametrize("mode", ["bucketed", "streamed"])
def test_optimize_level_matches_jax(scene, mode, monkeypatch):
    """Two outer iterations of the level with its production settings
    (device assembly, Schur globals, bf16 coefficients, 12 CG steps) in the
    bucketed layout, one-shot and streamed in 2 frame chunks by the port's
    own planner at a pinned budget, against JAX's level in the same layout."""
    prob = scene["prob"]
    jcfg, tcfg = _solve_cfgs()
    k, nbc = 3, scene["fb"].shape[1]
    budget = None if mode == "bucketed" else _streaming_budget(k, nbc, 2)
    if mode == "streamed":
        real = j_opt.plan_eg_layout

        def streamed(*a, **kw):
            fb, reason, _ = real(*a, **kw)
            return fb, reason + ", streamed in 2 chunks", 2

        monkeypatch.setattr(j_opt, "plan_eg_layout", streamed)
    jargs = (prob.grid, prob.topo, prob.params, jcfg, prob.cam, prob.depths, prob.images, prob.voxel_sh,
             prob.thres_shell)
    p_j, _, st_j = j_opt.optimize_level(*jargs, rgbd_level=0)
    p_t, _, st_t = opt.optimize_level(*_level_args(prob, tcfg), budget=budget, device="cpu")
    assert st_t.bucket_blocks == nbc and st_t.elements == k * nbc * 512
    assert st_t.eg_chunks == (1 if mode == "bucketed" else 2), st_t.reason
    assert ("streamed in 2 chunks" in st_t.reason) == (mode == "streamed")
    np.testing.assert_allclose(st_t.costs_before[0], st_j.costs_before[0], rtol=1e-4)
    np.testing.assert_allclose(st_t.costs_before, st_j.costs_before, rtol=2e-2)
    np.testing.assert_allclose(st_t.costs_after, st_j.costs_after, rtol=2e-2)
    np.testing.assert_allclose(p_t.sdf.numpy(), to_numpy(p_j.sdf), atol=2e-3)
    assert all(c1 <= c0 for c0, c1 in zip(st_t.costs_before, st_t.costs_after))


def test_out_of_memory_replans_once(scene, monkeypatch):
    """An out-of-memory error at the first outer step replans the layout at
    0.6× the budget and retries once; a second one, one at a later
    iteration, and any other error propagate."""
    _, tcfg = _solve_cfgs()
    args = _level_args(scene["prob"], dataclasses.replace(tcfg, iterations=2, lm_steps=2))
    real_step, real_plan = opt.fused_outer_step, opt.plan_eg_layout
    budgets = []

    def plan(*a, **kw):
        budgets.append(kw["budget"])
        return real_plan(*a, **kw)

    def failing(at_calls, exc):
        calls = []

        def step(*a, **kw):
            calls.append(kw["bmap"])
            if len(calls) in at_calls:
                raise exc
            return real_step(*a, **kw)

        return step, calls

    monkeypatch.setattr(opt, "plan_eg_layout", plan)
    budget = 1e12
    step, calls = failing({1}, torch.cuda.OutOfMemoryError("CUDA out of memory (test)"))
    monkeypatch.setattr(opt, "fused_outer_step", step)
    _, _, st = opt.optimize_level(*args, budget=budget, cg_iters=4, device="cpu")
    assert budgets == [budget, 0.6 * budget]
    assert len(calls) == 3 and len(st.costs_before) == 2 and st.eg_chunks == 1
    assert st.bucket_blocks == scene["fb"].shape[1]

    for at_calls, exc in (({1, 2}, torch.cuda.OutOfMemoryError("again")),
                          ({2}, torch.cuda.OutOfMemoryError("at iteration 1")),
                          ({1}, RuntimeError("unrelated"))):
        budgets.clear()
        step, calls = failing(at_calls, exc)
        monkeypatch.setattr(opt, "fused_outer_step", step)
        with pytest.raises(type(exc), match=str(exc)):
            opt.optimize_level(*args, budget=budget, cg_iters=4, device="cpu")
        assert budgets == ([budget, 0.6 * budget] if at_calls == {1, 2} else [budget])


def test_planner_constants_never_trim_where_streaming_fits(scene):
    """The streamed layout's bytes cover the dense layout's, so a plan that
    rejects the exact buckets one-shot streams in ≥ 2 chunks; over a sweep
    of budgets the plan trims only where one-frame chunks cannot fit, and at
    920–1,100 B per exact element (below the dense bytes) it streams."""
    assert opt._EG_CHUNK_PERSIST_BYTES + opt._EG_CHUNK_TRANSIENT_BYTES >= opt._EG_DENSE_BYTES_PER_ELEMENT
    prob = scene["prob"]
    _, tcfg = _solve_cfgs()
    grid, _, params = _level_args(prob, tcfg)[:3]
    layout = BlockLayout.build(grid)
    k, s = 3, 512
    el = k * scene["fb"].shape[1] * s

    def plan(budget):
        return opt.plan_eg_layout(layout, to_numpy(prob.params.poses), to_numpy(prob.params.intr), tcfg, 64, 48,
                                  grid.voxel_size, prob.thres_shell, to_numpy(prob.depths), budget=budget, device="cpu")

    seen = set()
    for per_el in np.geomspace(50.0, 4000.0, 40).tolist() + [920.0, 950.0, 1000.0, 1100.0]:
        budget = per_el * el
        fb, reason, chunks = plan(budget)
        persist = el * opt._EG_CHUNK_PERSIST_BYTES
        f_max = (budget - persist) // (el / k * opt._EG_CHUNK_TRANSIENT_BYTES)
        stream_fits = persist < budget and el * opt._EG_ASSEMBLY_BYTES <= budget and f_max >= 1
        if "frame-capped" in reason:
            assert not stream_fits, (per_el, reason)
            seen.add("capped")
        elif chunks > 1:
            assert stream_fits and el * opt._EG_DENSE_BYTES_PER_ELEMENT > budget, (per_el, reason)
            assert persist + -(-k // chunks) * el / k * opt._EG_CHUNK_TRANSIENT_BYTES <= budget
            seen.add("streamed")
        else:
            assert fb.shape[1] == scene["fb"].shape[1] and el * opt._EG_DENSE_BYTES_PER_ELEMENT <= budget
            seen.add("one-shot")
        if 920.0 <= per_el <= 1100.0:
            assert "frame-capped" not in reason, (per_el, reason)
    assert seen == {"capped", "streamed", "one-shot"}
