"""Port parity of the flat-table oracle path (`build_assembly`, the flat
residuals, `jtj_diag`, the flat `gn_iteration`, `to_block_problem`,
`optimize_level(use_blocks=False)`) against `intrinsic3d_tpu` on the CPU, and
of the port's flat path against its own block path.

The problem is `tests/test_blockform.py`'s (voxel 0.02 m, 64×48, 2 frames, 2
observations, perturbed SDF and albedo), built by both packages from the
same numpy code. Tolerances:

- `build_assembly`: per-voxel and pairwise fields and masks exact, λ̃ and
  the element weights rtol 1e-5, element index fields exact on the elements
  both packages keep; the active element sets may differ by occlusion flips
  on at most 1% of the elements (the JAX depth probe errs by O(2⁻¹⁶)
  relative near the 0.02 m gate).
- the residual stack and the total cost on JAX's own assembly carried
  across: rtol 1e-5 with an absolute floor of 1e-5 × the largest magnitude
  (the JAX flat sampler's bf16x3 matmuls against the port's float32 kernel
  path, ~1e-6 relative).
- `jtj_diag`: rtol 1e-4 (floor 1e-4 × max; summation order).
- one flat `gn_iteration` (lm 3, cg 6): cost before rtol 1e-5, after rtol
  1e-3; sdf and poses rtol 5e-3, atol 5e-6 (`test_blockform.py`'s).
- `to_block_problem`, dense and bucketed: equal to JAX's fields.
- `optimize_level(use_blocks=False)`, 2 iterations: costs rtol 1e-3.
- the port's flat path against its block path: `test_blockform.py`'s first
  four tests' quantities and tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsic3d_tpu.grid.blocks import BlockLayout as JBlockLayout
from intrinsic3d_tpu.refine import blockform as jbf
from intrinsic3d_tpu.refine.optimizer import optimize_level as j_optimize_level
from intrinsic3d_tpu.refine.residuals import all_residuals as j_all_residuals
from intrinsic3d_tpu.refine.residuals import total_cost as j_total_cost
from intrinsic3d_tpu.refine.solver import gn_iteration as j_gn_iteration
from intrinsic3d_tpu.refine.solver import jtj_diag as j_jtj_diag
from intrinsic3d_tpu.synthetic import build_sphere_problem as j_build_sphere_problem

from intrinsic3d_torch.convert import assembly_from_numpy, masks_from_numpy, params_from_numpy
from intrinsic3d_torch.grid.blocks import BlockLayout
from intrinsic3d_torch.refine import blockform
from intrinsic3d_torch.refine.assembly import build_assembly
from intrinsic3d_torch.refine.optimizer import optimize_level
from intrinsic3d_torch.refine.residuals import Params, all_residuals, total_cost
from intrinsic3d_torch.refine.solver import gn_iteration, jtj_diag
from intrinsic3d_torch.synthetic import build_sphere_problem

from torch_support import close, one_torch_thread, to_numpy  # noqa: F401

PROBLEM = dict(
    voxel_size=0.02, image_size=(64, 48), num_frames=2, num_observations=2, perturb_sdf=0.002, perturb_albedo=0.05,
)
GN = dict(lm_steps=3, cg_iters=6)


@pytest.fixture(scope="module")
def probs():
    jprob = j_build_sphere_problem(**PROBLEM)
    tprob = build_sphere_problem(**PROBLEM, device="cpu")
    for a, b in zip(jprob.params, tprob.params):
        np.testing.assert_array_equal(to_numpy(b), np.asarray(a))
    np.testing.assert_array_equal(to_numpy(tprob.images), np.asarray(jprob.images))
    np.testing.assert_array_equal(to_numpy(tprob.depths), np.asarray(jprob.depths))
    return jprob, tprob


@pytest.fixture(scope="module")
def assemblies(probs):
    """Each package's own flat assembly and masks of the same problem."""
    jprob, tprob = probs
    jasm, jmasks = jprob.assemble()
    tasm, tmasks = tprob.assemble()
    return (jasm, jmasks), (tasm, tmasks)


@pytest.fixture(scope="module")
def carried(probs, assemblies):
    """JAX's assembly, masks and params carried into the port."""
    (jasm, jmasks), _ = assemblies
    jprob, _ = probs
    tasm = assembly_from_numpy(**{k: np.asarray(v) for k, v in jasm._asdict().items()}, device="cpu")
    tmasks = masks_from_numpy(*(np.asarray(m) for m in jmasks), device="cpu")
    tparams = params_from_numpy(*(np.asarray(p) for p in jprob.params), device="cpu")
    return tparams, tasm, tmasks


def _element_keys(asm, k):
    """(voxel, frame) key of every element: the stencil's first tap is the
    voxel itself."""
    return to_numpy(asm.eg_sdf10_idx)[:, 0].astype(np.int64) * k + to_numpy(asm.eg_frame).astype(np.int64)


def _matched_elements(jasm, tasm, k):
    """Indices into JAX's and the port's element rows of the elements both
    keep with positive weight, after checking that the kept sets differ on
    at most 1% of them."""
    jw, tw = to_numpy(jasm.eg_w), to_numpy(tasm.eg_w)
    jkeys, tkeys = _element_keys(jasm, k), _element_keys(tasm, k)
    jset, tset = set(jkeys[jw > 0].tolist()), set(tkeys[tw > 0].tolist())
    assert len(jset) > 100
    assert len(jset ^ tset) <= 0.01 * len(jset), len(jset ^ tset)
    common = np.array(sorted(jset & tset), np.int64)
    jpos = {key: i for i, key in enumerate(jkeys.tolist()) if jw[i] > 0}
    tpos = {key: i for i, key in enumerate(tkeys.tolist()) if tw[i] > 0}
    return np.array([jpos[c] for c in common.tolist()]), np.array([tpos[c] for c in common.tolist()])


ELEMENT_FIELDS = ("eg_sdf10_idx", "eg_alb4_idx", "eg_frame", "eg_vpos", "eg_sh", "eg_w")
TABLE_FIELDS = ("er_idx", "er_w", "es_idx", "es_ref", "es_w", "ea_pairs", "ea_w", "images")


@pytest.mark.parametrize(
    "field",
    ELEMENT_FIELDS + TABLE_FIELDS + ("lam", "pyr_scale", "voxel_size", "order")
    + tuple(f"masks.{m}" for m in ("sdf", "albedo", "poses", "intr", "dist")),
)
def test_build_assembly_matches_jax(probs, assemblies, field):
    (jasm, jmasks), (tasm, tmasks) = assemblies
    k = int(probs[0].params.poses.shape[0])
    if field.startswith("masks."):
        name = field.split(".")[1]
        np.testing.assert_array_equal(to_numpy(getattr(tmasks, name)), np.asarray(getattr(jmasks, name)))
        return
    if field == "order":
        # the port keeps JAX's np.flatnonzero element order (it drops only
        # the power-of-two padding): the elements both keep come in the same
        # sequence
        ji, ti = _matched_elements(jasm, tasm, k)
        np.testing.assert_array_equal(_element_keys(tasm, k)[np.sort(ti)], _element_keys(jasm, k)[np.sort(ji)])
        return
    if field in ELEMENT_FIELDS:
        ji, ti = _matched_elements(jasm, tasm, k)
        got, want = to_numpy(getattr(tasm, field))[ti], np.asarray(getattr(jasm, field))[ji]
        if field in ("eg_sh", "eg_w"):
            np.testing.assert_allclose(got, want, rtol=1e-5)
        else:
            np.testing.assert_array_equal(got, want)
        return
    got, want = to_numpy(getattr(tasm, field)), np.asarray(getattr(jasm, field))
    if field in ("lam", "pyr_scale", "voxel_size", "er_w", "es_ref", "es_w", "ea_w", "images"):
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["all_residuals", "total_cost"])
def test_flat_residuals_match_jax(probs, assemblies, carried, fn):
    (jasm, _), _ = assemblies
    tparams, tasm, _ = carried
    jfn, tfn = {"all_residuals": (j_all_residuals, all_residuals), "total_cost": (j_total_cost, total_cost)}[fn]
    want = np.asarray(jax.jit(jfn)(probs[0].params, jasm))
    got = tfn(tparams, tasm)
    if fn == "total_cost":
        assert float(got) > 0.0
    close(got, want, rtol=1e-5)


@pytest.fixture(scope="module")
def jtj_pair(probs, assemblies, carried):
    (jasm, _), _ = assemblies
    tparams, tasm, _ = carried
    return jtj_diag(tparams, tasm), jax.jit(j_jtj_diag)(probs[0].params, jasm)


@pytest.mark.parametrize("leaf", Params._fields)
def test_jtj_diag_matches_jax(jtj_pair, leaf):
    got, want = jtj_pair
    close(getattr(got, leaf), np.asarray(getattr(want, leaf)), rtol=1e-4)


@pytest.fixture(scope="module")
def gn_pair(probs, assemblies, carried):
    (jasm, jmasks), _ = assemblies
    tparams, tasm, tmasks = carried
    got = gn_iteration(tparams, tasm, tmasks, 1e-4, **GN, device="cpu")
    # static arguments passed as JAX's flat `optimize_level` passes them,
    # so `level_pair` reuses this compiled step
    want = j_gn_iteration(
        probs[0].params, jasm, jmasks, jnp.float32(1e-4), GN["lm_steps"], GN["cg_iters"], schur_globals=False
    )
    return got, want


@pytest.mark.parametrize("quantity", ["cost_before", "cost_after", "sdf", "poses"])
def test_flat_gn_iteration_matches_jax(gn_pair, quantity):
    (tp, tc0, tc1, _, _), (jp, jc0, jc1, _, _) = gn_pair
    if quantity == "cost_before":
        np.testing.assert_allclose(float(tc0), float(jc0), rtol=1e-5)
    elif quantity == "cost_after":
        np.testing.assert_allclose(float(tc1), float(jc1), rtol=1e-3)
        assert float(tc1) < float(tc0)
    else:
        np.testing.assert_allclose(to_numpy(getattr(tp, quantity)), np.asarray(getattr(jp, quantity)), rtol=5e-3,
                                   atol=5e-6)


@pytest.fixture(scope="module")
def block_pairs(probs, assemblies, carried):
    """`to_block_problem` of JAX's assembly in both packages, dense and
    bucketed, on a B = 4 layout."""
    jprob, tprob = probs
    (jasm, jmasks), _ = assemblies
    tparams, tasm, tmasks = carried
    jlayout = JBlockLayout.build(jprob.grid, block=4)
    tlayout = BlockLayout.build(tprob.grid, block=4)
    out = {}
    for bucket in (False, True):
        want = jbf.to_block_problem(jlayout, jprob.topo.coords, jasm, jmasks, jprob.params, bucket=bucket)
        got = blockform.to_block_problem(tlayout, tprob.topo.coords, tasm, tmasks, tparams, bucket=bucket, device="cpu")
        out[bucket] = (got, want)
    return out


BLOCK_FIELDS = ("eg_w", "eg_sh", "eg_vpos", "er_w", "es_ref", "es_w", "ea_w", "lam", "bmap")


@pytest.mark.parametrize("bucket", [False, True], ids=["dense", "bucketed"])
@pytest.mark.parametrize(
    "field", BLOCK_FIELDS + ("params.sdf", "params.albedo", "masks.sdf", "masks.albedo", "masks.poses")
)
def test_to_block_problem_matches_jax(block_pairs, bucket, field):
    (tparams, tbasm, tmasks), (jparams, jbasm, jmasks) = block_pairs[bucket]
    if field == "bmap":
        if not bucket:
            assert tbasm.bmap is None and jbasm.bmap is None
            return
        got, want = tbasm.bmap, jbasm.bmap
    elif "." in field:
        group, name = field.split(".")
        got, want = (getattr({"params": tparams, "masks": tmasks}[group], name),
                     getattr({"params": jparams, "masks": jmasks}[group], name))
    else:
        got, want = getattr(tbasm, field), getattr(jbasm, field)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_to_block_problem_raises_outside_layout(probs, carried):
    """An active element whose voxel has no block in the layout raises."""
    _, tprob = probs
    tparams, tasm, tmasks = carried
    far = tasm.eg_vpos.clone()
    far[int(torch.nonzero(tasm.eg_w > 0)[0])] += 1000
    layout = BlockLayout.build(tprob.grid, block=4)
    with pytest.raises(ValueError, match="outside the block layout"):
        blockform.to_block_problem(layout, tprob.topo.coords, tasm._replace(eg_vpos=far), tmasks, tparams, device="cpu")


@pytest.fixture(scope="module")
def level_pair(probs):
    """Two flat `optimize_level` iterations in each package, each from its
    own problem (the flat assembly rebuilt at every iteration)."""
    jprob, tprob = probs
    out = []
    for prob, fn, extra in ((jprob, j_optimize_level, {}), (tprob, optimize_level, {"device": "cpu"})):
        # the flat table ignores `schur_globals`; False keeps JAX's jitted
        # step the one `gn_pair` compiled
        cfg = dataclasses.replace(prob.cfg, iterations=2, lm_steps=GN["lm_steps"], schur_globals=False)
        _, _, stats = fn(
            prob.grid, prob.topo, prob.params, cfg, prob.cam, prob.depths, prob.images, prob.voxel_sh,
            prob.thres_shell, 0, cg_iters=GN["cg_iters"], use_blocks=False, **extra,
        )
        out.append(stats)
    return out


@pytest.mark.parametrize("quantity", ["costs_before", "costs_after"])
def test_flat_optimize_level_matches_jax(level_pair, quantity):
    tstats, jstats = level_pair[1], level_pair[0]
    np.testing.assert_allclose(getattr(tstats, quantity), getattr(jstats, quantity), rtol=1e-3)
    assert all(c1 <= c0 for c0, c1 in zip(tstats.costs_before, tstats.costs_after))
    assert tstats.reason == "flat table" and tstats.elements > 0


@pytest.fixture(scope="module")
def own_block(probs, assemblies):
    """The port's own flat problem and its block form (B = 4)."""
    _, tprob = probs
    _, (tasm, tmasks) = assemblies
    layout = BlockLayout.build(tprob.grid, block=4)
    bparams, basm, bmasks = blockform.to_block_problem(
        layout, tprob.topo.coords, tasm, tmasks, tprob.params, device="cpu"
    )
    return layout, tasm, tmasks, bparams, basm, bmasks


def _cost_grad(fn, params):
    leaves = [p.detach().requires_grad_(True) for p in params]
    cost = fn(Params(*leaves))
    return cost.detach(), Params(*torch.autograd.grad(cost, leaves))


@pytest.mark.parametrize("quantity", ["roundtrip", "cost_and_grad", "jacobi_diag", "gn_iteration"])
def test_flat_matches_own_block_path(probs, own_block, quantity):
    """`test_blockform.py`'s first four tests on the port alone: the block
    layout is a pure re-layout of the flat table's energy."""
    tprob = probs[1]
    layout, asm, masks, bparams, basm, bmasks = own_block
    table = lambda f: blockform.dense_to_table(layout, f)  # noqa: E731
    if quantity == "roundtrip":
        back = blockform.params_from_block(layout, bparams)
        np.testing.assert_array_equal(to_numpy(back.sdf), to_numpy(tprob.params.sdf))
        np.testing.assert_array_equal(to_numpy(back.albedo), to_numpy(tprob.params.albedo))
    elif quantity == "cost_and_grad":
        c_t, g_t = _cost_grad(lambda p: total_cost(p, asm), tprob.params)
        c_b, g_b = _cost_grad(
            lambda p: 0.5 * torch.sum(blockform.block_all_residuals(p, basm, masked=False) ** 2), bparams
        )
        assert float(c_t) > 0.0
        np.testing.assert_allclose(float(c_b), float(c_t), rtol=1e-5)
        for got, want in ((table(g_b.sdf), g_t.sdf), (table(g_b.albedo), g_t.albedo), (g_b.poses, g_t.poses),
                          (g_b.dist, g_t.dist)):
            np.testing.assert_allclose(to_numpy(got), to_numpy(want), rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(to_numpy(g_b.intr), to_numpy(g_t.intr), rtol=2e-4)
    elif quantity == "jacobi_diag":
        d_t = jtj_diag(tprob.params, asm)
        _, lin = blockform.linearize_block(bparams, basm)
        d_b = blockform.diag_from_lin(lin, basm)
        for got, want in ((table(d_b.sdf), d_t.sdf), (table(d_b.albedo), d_t.albedo), (d_b.poses, d_t.poses),
                          (d_b.dist, d_t.dist)):
            np.testing.assert_allclose(to_numpy(got), to_numpy(want), rtol=5e-2, atol=2e-3)
        np.testing.assert_allclose(to_numpy(d_b.intr), to_numpy(d_t.intr), rtol=5e-2)
        assert float(torch.sum(torch.abs(d_b.sdf[-1]))) == 0.0
    else:
        p_t, c0_t, c1_t, _, _ = gn_iteration(tprob.params, asm, masks, 1e-4, **GN, device="cpu")
        p_b, c0_b, c1_b, _, _ = gn_iteration(
            bparams, basm, bmasks, 1e-4, **GN, cg_coeff_dtype="float32", device="cpu"
        )
        np.testing.assert_allclose(float(c0_b), float(c0_t), rtol=1e-5)
        np.testing.assert_allclose(float(c1_b), float(c1_t), rtol=1e-3)
        assert float(c1_b) < float(c0_b)
        np.testing.assert_allclose(to_numpy(table(p_b.sdf)), to_numpy(p_t.sdf), rtol=5e-3, atol=5e-6)
        np.testing.assert_allclose(to_numpy(p_b.poses), to_numpy(p_t.poses), rtol=5e-3, atol=5e-6)


def test_flat_entry_points_default_to_the_card(probs):
    """`build_assembly`, `gn_iteration`, `to_block_problem` and
    `optimize_level` default to `device="cuda"`: without a card they raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    tprob = probs[1]
    asm, masks = tprob.assemble()
    calls = [
        lambda: build_assembly(
            tprob.grid, tprob.topo, tprob.params, tprob.cam, tprob.depths, tprob.images, tprob.voxel_sh,
            tprob.thres_shell, 0.02, 2, 0.2, 10.0, 10.0, 0.1, 1.0,
        ),
        lambda: gn_iteration(tprob.params, asm, masks, 1e-4, **GN),
        lambda: blockform.to_block_problem(BlockLayout.build(tprob.grid), tprob.topo.coords, asm, masks, tprob.params),
        lambda: optimize_level(
            tprob.grid, tprob.topo, tprob.params, tprob.cfg, tprob.cam, tprob.depths, tprob.images, tprob.voxel_sh,
            tprob.thres_shell, 0, use_blocks=False,
        ),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA device was requested"):
            call()
