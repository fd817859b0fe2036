"""Camera-parameter refinement through the port's block path: twins of
`tests/test_pose_refinement.py` (pose recovery, tangential distortion
recovery, and the pose/intrinsics/distortion gradient chain against finite
differences), at the same sizes and bars, each beside the JAX package on
the same seeded inputs.

The JAX tests run the flat-table path (`SphereProblem.assemble`, which
collects observations through the true camera, + `gn_iteration`); the port
runs device assembly and the block-dense `gn_iteration`, the path of its
level driver and of the JAX package's. Tolerances against JAX, each
measured on these inputs (the full-length runs with
`python tests/torch_parity_report.py twins`) and stated with its reason:
- pose recovery against the JAX test's own flat-path run, over the first 3
  of its 12 camera-only relinearizations (the JAX side compiles for ~20 s
  and steps at ~3 s an iteration on the CPU): poses atol 2e-4 (measured
  4.3e-6), costs rtol 1e-3 (measured 2.1e-5): bf16 coefficients inside
  both PCGs and the JAX sampler's bf16 hi/lo split move each step
  slightly. Over all 12, 2.9e-5 apart (the JAX block path lands 3.9e-4
  from its flat path);
- distortion recovery against the JAX package's block path over the
  first 3 relinearizations: distortion atol 2e-5 (measured 1.6e-7; 1.7e-5
  after 40), costs rtol 1e-4 (measured 2.8e-6). The flat path is no
  reference here: its observations come through the true lens, so it
  minimizes another energy and recovers less (p1 0.041 where both block
  paths reach 0.127 in 40 relinearizations). The block path clears the
  JAX test's bars in 10 relinearizations (mean error 0.13 of the start's
  against the bar's 0.7), so the twin runs 10, not 40;
- gradients of the total cost in float64 against JAX's flat-path gradient:
  relative 1e-3 of the larger magnitude (measured 1.9e-4: the flat table
  and the block layout assemble this problem's energy with different
  observation weights' rounding); against central finite differences the
  JAX test's 5% (measured 5.3e-4).
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
from intrinsic3d_tpu.refine.residuals import total_cost as j_total_cost
from intrinsic3d_tpu.refine.solver import gn_iteration as j_gn_iteration
from intrinsic3d_tpu.synthetic import build_sphere_problem as j_build_sphere_problem

from intrinsic3d_torch.config import RefinementConfig
from intrinsic3d_torch.refine import blockform
from intrinsic3d_torch.refine.solver import gn_iteration
from intrinsic3d_torch.synthetic import build_sphere_problem

BASE = dict(
    num_observations=3, occlusion_distance=0.03, lambda_r0=20.0, lambda_r1=20.0, lambda_s0=20.0,
    lambda_s1=20.0, lambda_a=0.1,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes: one intra-op
    thread per process keeps torch from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problems(fix, **kw):
    cfg = RefinementConfig(**BASE, fix_poses=fix[0], fix_intrinsics=fix[1], fix_distortion=fix[2])
    jcfg = JRefinementConfig(**dataclasses.asdict(cfg))
    return build_sphere_problem(cfg=cfg, device="cpu", **kw), j_build_sphere_problem(cfg=jcfg, **kw)


def _run_port(prob, start, iters, lm=8, cg=12, dist_mask=None, mu=1e-4):
    """The JAX test's `run_iters(cameras_only=True)` on the block path:
    device assembly at each iterate, voxel parameters frozen. Returns the
    block-dense parameters, the (before, after) costs and the last μ."""
    setup = prob.level()
    bp = setup.params._replace(**{k: torch.as_tensor(v) for k, v in start.items()})
    mu = torch.as_tensor(mu)
    costs = []
    for _ in range(iters):
        asm, masks = setup.assemble(bp, prob.depths, prob.images)
        masks = masks._replace(sdf=torch.zeros_like(masks.sdf), albedo=torch.zeros_like(masks.albedo))
        if dist_mask is not None:
            masks = masks._replace(dist=torch.as_tensor(dist_mask))
        bp, c0, c1, mu, _ = gn_iteration(bp, asm, masks, mu, lm, cg, device="cpu")
        costs.append((float(c0), float(c1)))
    return bp, costs, mu


def _run_jax(prob, start, iters, lm=8, cg=12, dist_mask=None, mu=1e-4):
    """`tests/test_pose_refinement.py::run_iters(cameras_only=True)`, with
    `_run_port`'s arguments and returns."""
    prob.params = prob.params._replace(**{k: jnp.asarray(v) for k, v in start.items()})
    mu = jnp.float32(mu)
    costs = []
    for _ in range(iters):
        asm, masks = prob.assemble()
        masks = masks._replace(sdf=jnp.zeros_like(masks.sdf), albedo=jnp.zeros_like(masks.albedo))
        if dist_mask is not None:
            masks = masks._replace(dist=jnp.asarray(dist_mask))
        params, c0, c1, mu, _ = j_gn_iteration(prob.params, asm, masks, mu, lm, cg)
        prob.params = params
        costs.append((float(c0), float(c1)))
    return prob.params, costs, mu


def _run_jax_block(prob, start, iters, lm=8, cg=12, dist_mask=None, mu=1e-4):
    """`_run_port` in the JAX package: its device assembly and block-dense
    `gn_iteration`, jitted as one step (the interpreted Pallas samplers run
    several times faster compiled than dispatched eagerly). Returns the
    block-dense parameters, the (before, after) costs and the last μ."""
    layout = JBlockLayout.build(prob.grid)
    static = j_build_level_static(layout, prob.grid, prob.topo, prob.voxel_sh)
    sdf_plan, alb_plan = jbf.layout_plans(layout)
    bp = prob.params._replace(sdf=jbf.table_to_dense(layout, prob.params.sdf),
                              albedo=jbf.table_to_dense(layout, prob.params.albedo),
                              **{k: jnp.asarray(v) for k, v in start.items()})
    cfg = prob.cfg
    scalars = tuple(jnp.float32(v) for v in (1.0, prob.grid.voxel_size, prob.grid.truncation, prob.thres_shell,
                                             cfg.occlusion_distance))
    lambdas = jnp.asarray([cfg.lambda_g, 10.0, 10.0, cfg.lambda_a], jnp.float32)
    kw = dict(num_obs=cfg.num_observations, width=int(prob.images.shape[2]), height=int(prob.images.shape[1]),
              fix_poses=cfg.fix_poses, fix_intrinsics=cfg.fix_intrinsics, fix_distortion=cfg.fix_distortion,
              use_albedo=cfg.lambda_a >= 0.0)

    @jax.jit
    def step(bp, mu):
        asm, masks = j_device_assembly(static, sdf_plan, alb_plan, bp, prob.depths, prob.images, *scalars, lambdas,
                                       **kw)
        masks = masks._replace(sdf=jnp.zeros_like(masks.sdf), albedo=jnp.zeros_like(masks.albedo))
        if dist_mask is not None:
            masks = masks._replace(dist=jnp.asarray(dist_mask))
        return j_gn_iteration(bp, asm, masks, mu, lm, cg)

    mu = jnp.float32(mu)
    costs = []
    for _ in range(iters):
        bp, c0, c1, mu, _ = step(bp, mu)
        costs.append((float(c0), float(c1)))
    return bp, costs, mu


def test_pose_recovery():
    """~3° rotation and ~1 cm translation perturbations of frames 1 and 2
    (frame 0 starts at its true pose) move back toward the true poses: the JAX
    test's bars, and the JAX function's recovered poses."""
    prob, jprob = _problems((False, True, True), voxel_size=0.0075, image_size=(128, 96), num_frames=3,
                            num_observations=3)
    true_poses = prob.params.poses.numpy().copy()
    np.testing.assert_array_equal(true_poses, np.asarray(jprob.params.poses))
    rng = np.random.default_rng(0)
    bad = true_poses.copy()
    bad[1:, :3] += rng.normal(0, 0.05, bad[1:, :3].shape)
    bad[1:, 3:] += rng.normal(0, 0.01, bad[1:, 3:].shape)
    start = dict(poses=bad.astype(np.float32))

    # the first 3 relinearizations, held against the JAX test's own run,
    # then the other 9
    first, costs, mu = _run_port(prob, start, iters=3)
    jout, jcosts, _ = _run_jax(jprob, start, iters=3)
    np.testing.assert_allclose(first.poses.numpy(), np.asarray(jout.poses), atol=2e-4)
    np.testing.assert_allclose(costs, jcosts, rtol=1e-3)
    out, more, _ = _run_port(prob, dict(poses=first.poses), iters=9, mu=mu)
    costs += more
    got = out.poses.numpy()
    err0_rot = np.abs(bad[1:, :3] - true_poses[1:, :3]).mean()
    err0_t = np.abs(bad[1:, 3:] - true_poses[1:, 3:]).mean()
    err1_rot = np.abs(got[1:, :3] - true_poses[1:, :3]).mean()
    err1_t = np.abs(got[1:, 3:] - true_poses[1:, 3:]).mean()
    assert err1_rot < 0.9 * err0_rot
    assert err1_t < max(err0_t, 2.0 * prob.grid.voxel_size)
    assert costs[-1][1] < costs[0][0]


def test_distortion_recovery():
    """Tangential distortion recovered through the block path from a
    standing start (radial frozen at calibration), to the JAX test's bars:
    more than 30% of each coefficient recovered with the right sign, the
    mean error under 0.7 of the start's, the cost down. The block path
    clears them in 10 relinearizations (the flat path takes 40)."""
    true_dist = np.array([0.08, -0.04, 0.0, 0.10, -0.06], np.float32)
    prob, jprob = _problems((True, True, False), voxel_size=0.0075, image_size=(128, 96), num_frames=3,
                            num_observations=3, dist=true_dist)
    np.testing.assert_allclose(prob.params.dist.numpy(), true_dist)
    start = true_dist.copy()
    start[3:] = 0.0
    dmask = np.array([0.0, 0.0, 0.0, 1.0, 1.0], np.float32)

    # the first 3 relinearizations, held against the JAX block path's, then
    # 7 more
    first, costs, mu = _run_port(prob, dict(dist=start), iters=3, dist_mask=dmask)
    jout, jcosts, _ = _run_jax_block(jprob, dict(dist=start), iters=3, dist_mask=dmask)
    np.testing.assert_allclose(first.dist.numpy(), np.asarray(jout.dist), atol=2e-5)
    np.testing.assert_allclose(costs, jcosts, rtol=1e-4)
    out, more, _ = _run_port(prob, dict(dist=first.dist), iters=7, dist_mask=dmask, mu=mu)
    costs += more
    got = out.dist.numpy()
    np.testing.assert_array_equal(got[:3], true_dist[:3])
    assert costs[-1][1] < costs[0][0]
    err0 = float(np.abs(true_dist[3:]).mean())
    err1 = float(np.abs(got[3:] - true_dist[3:]).mean())
    assert err1 < 0.7 * err0, (got, true_dist)
    assert got[3] > 0.3 * true_dist[3], got
    assert got[4] < 0.3 * true_dist[4], got


def test_camera_gradients_match_finite_differences():
    """Autograd of the block path's total cost in float64 against central
    finite differences (the JAX test's 5% bar) and against JAX's gradient of
    its flat-path total cost on the same problem."""
    prob, jprob = _problems((False, False, False), voxel_size=0.01, image_size=(100, 80), num_frames=3,
                            num_observations=3, perturb_sdf=0.002, perturb_albedo=0.05)
    setup = prob.level()
    asm, _ = setup.assemble(setup.params, prob.depths, prob.images)
    f64 = lambda a: a.to(torch.float64) if torch.is_tensor(a) and a.dtype == torch.float32 else a  # noqa: E731
    asm = asm._replace(**{k: f64(v) for k, v in asm._asdict().items()})
    params = setup.params._replace(**{k: v.to(torch.float64) for k, v in setup.params._asdict().items()})

    def cost(p):
        return blockform.block_total_cost(p, asm)

    leaves = {k: getattr(params, k).clone().requires_grad_(k in ("poses", "intr", "dist")) for k in params._fields}
    cost(params._replace(**leaves)).backward()
    grad = {k: leaves[k].grad for k in ("poses", "intr", "dist")}

    def fd(name, index, eps):
        def at(s):
            v = getattr(params, name).clone()
            v[index] += s
            return float(cost(params._replace(**{name: v})))

        return (at(eps) - at(-eps)) / (2 * eps)

    checks = [(("poses", (1, k)), 1e-4) for k in range(6)]
    checks += [(("intr", (k,)), 1e-2) for k in range(4)]
    checks += [(("dist", (k,)), 1e-4) for k in range(5)]
    port_grads = []
    for (name, index), eps in checks:
        g_ad = float(grad[name][index])
        g_fd = fd(name, index, eps)
        scale = max(abs(g_ad), abs(g_fd), 1e-3)
        # the cost is only C⁰ where elements cross image-validity borders,
        # so a few entries carry O(eps) kink error
        assert abs(g_ad - g_fd) / scale < 0.05, (name, index, g_ad, g_fd)
        port_grads.append(g_ad)

    jax.config.update("jax_enable_x64", True)
    try:
        jasm, _ = jprob.assemble()
        jasm = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64) if a.dtype == jnp.float32 else a, jasm)
        jparams = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), jprob.params)
        jgrad = jax.grad(lambda p: j_total_cost(p, jasm))(jparams)
        jax_grads = [float(getattr(jgrad, name)[index]) for (name, index), _ in checks]
    finally:
        jax.config.update("jax_enable_x64", False)
    for (key, _), g, jg in zip(checks, port_grads, jax_grads):
        assert abs(g - jg) <= 1e-3 * max(abs(g), abs(jg), 1e-3), (key, g, jg)
