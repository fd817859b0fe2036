"""Damped Gauss-Newton step with matrix-free PCG, on either problem layout.

Counterpart of `intrinsic3d_tpu/refine/solver.py`, replacing Ceres
(``nls_solver.cpp``): Levenberg-Marquardt on the normal equations with an
exact Jacobi preconditioner, solved by PCG to the inexact-Newton forcing
tolerance η, stopping after the first successful step so the outer loop
re-collects observations (``nls_solver.cpp:279-293``). `gn_iteration`
dispatches on the assembly type, as the JAX function does:

- a `blockform.BlockAssembly` (the production layout) is linearized by hand
  (`blockform.linearize_block`, one reverse pass for the E_g element
  Jacobian). With `schur_globals=True` the dense global block {poses,
  intrinsics, distortion} is eliminated exactly through its damped [G, G]
  Gram matrix and the PCG runs on the voxel space only. With
  `eg_chunks > 1` the E_g linearization and the LM acceptance forward are
  streamed over frame chunks (`blockform.linearize_block_chunked`,
  `blockform.block_total_cost`).
- a flat-table `residuals.Assembly` (the equivalence oracle) is linearized
  by autograd on the retained graph of the residual stack: Jᵀy is a reverse
  pass, J·v a double reverse pass through a dummy cotangent u
  (g(u) = Jᵀu is linear in u, so ∂⟨g, v⟩/∂u = J·v), and diag(JᵀJ) comes
  from `jtj_diag`. The JAX package uses forward mode (`jax.linearize`,
  `jacfwd`) there; the sampler's autograd function has no forward mode.

The PCG and LM loops run on the host: each PCG step reads its residual norm
and each LM try its acceptance, one device→host sync each (at most
lm_steps × (cg_iters + 2) per call), counted in `timer.HOST_READS`. The
linearization runs in a `solve.assemble` span and each LM try (its PCG, the
candidate's cost and the acceptance read) in a `solve.lm_try` span
(`timer.span`).

With `mesh` (a `parallel.sharding.Mesh`; the JAX function's `axis_name`)
the block branch runs on one rank's brick of a spatially sharded problem
(`parallel/spmd.py`): the voxel leaves are the rank's block rows, the global
leaves are replicated, and the cost, the global gradient, diagonal and
Gauss-Newton products, the Schur Gram matrix and every inner product are
all-reduced. Each host read of the loops is taken after its all-reduce, so
every rank takes the same branch and calls the same collectives in the same
order.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from intrinsic3d_torch.device import check_on, resolve_device
from intrinsic3d_torch.refine import blockform
from intrinsic3d_torch.refine.residuals import Assembly, Params, all_residuals, eg_elem, total_cost
from intrinsic3d_torch.timer import HOST_READS, span


class Masks(NamedTuple):
    """0/1 free-parameter masks, same structure as Params."""

    sdf: torch.Tensor
    albedo: torch.Tensor
    poses: torch.Tensor
    intr: torch.Tensor
    dist: torch.Tensor


def jtj_diag(params: Params, asm: Assembly) -> Params:
    """Exact diag(JᵀJ) of the flat-table residual stack.

    E_g: the element Jacobians `[M, 29]` from ONE reverse pass of
    Σ_m eg_elem(local29[m]) with `local29` as the leaf (each residual reads
    only its own row, so the gradient rows are the element Jacobians),
    squared and scatter-added; E_r / E_s / E_a in closed form. On the card
    the scatter-adds are atomic, so the sums' last bits vary with order."""
    n = params.sdf.shape[0]
    k = params.poses.shape[0]
    m = asm.eg_frame.shape[0]
    local = torch.cat(
        [
            params.sdf[asm.eg_sdf10_idx],
            params.albedo[asm.eg_alb4_idx],
            params.poses[asm.eg_frame],
            params.intr.expand(m, 4),
            params.dist.expand(m, 5),
        ],
        dim=-1,
    ).detach().requires_grad_(True)
    sqrt_wlam = torch.sqrt(asm.eg_w * asm.lam[0])
    with torch.enable_grad():
        r = eg_elem(local, asm.eg_sh, asm.eg_vpos, asm.eg_frame, asm.images, asm.pyr_scale, asm.voxel_size, sqrt_wlam)
        (jac,) = torch.autograd.grad(r.sum(), local)
    j2 = jac * jac  # [M, 29]

    d_sdf = params.sdf.new_zeros(n).index_add_(0, asm.eg_sdf10_idx.reshape(-1), j2[:, :10].reshape(-1))
    d_alb = params.albedo.new_zeros(n).index_add_(0, asm.eg_alb4_idx.reshape(-1), j2[:, 10:14].reshape(-1))
    d_pose = params.poses.new_zeros(k, 6).index_add_(0, asm.eg_frame, j2[:, 14:20])
    d_intr = torch.sum(j2[:, 20:24], dim=0)
    d_dist = torch.sum(j2[:, 24:29], dim=0)

    # E_r: ∂lap/∂center = −6, ∂lap/∂nbr = 1 (weighted)
    wl_r = asm.er_w * asm.lam[1]
    d_sdf.index_add_(0, asm.er_idx[:, 0], 36.0 * wl_r)
    d_sdf.index_add_(0, asm.er_idx[:, 1:].reshape(-1), wl_r.repeat_interleave(6))
    # E_s: ∂r/∂sdf = 1
    d_sdf.index_add_(0, asm.es_idx, asm.es_w * asm.lam[2])
    # E_a: ∂r/∂a_i = 1, ∂r/∂a_j = −1
    wl_a = asm.ea_w * asm.lam[3]
    d_alb.index_add_(0, asm.ea_pairs[:, 0], wl_a)
    d_alb.index_add_(0, asm.ea_pairs[:, 1], wl_a)
    return Params(d_sdf, d_alb, d_pose, d_intr, d_dist)


def linearize_flat(params: Params, asm: Assembly):
    """Linearize the flat-table residual stack at `params` by autograd:
    returns (cost0, jv, jt, grad) with `jv(v: Params) → [R]` and
    `jt(y [R]) → Params` on the retained graph (Jᵀy by one reverse pass, J·v
    by the double reverse pass through a dummy cotangent)."""
    leaves = [p.detach().requires_grad_(True) for p in params]
    with torch.enable_grad():
        r_graph = all_residuals(Params(*leaves), asm)
        u = torch.zeros_like(r_graph, requires_grad=True)
        g_u = torch.autograd.grad(r_graph, leaves, u, create_graph=True)

    def jt(y) -> Params:
        return Params(*torch.autograd.grad(r_graph, leaves, y, retain_graph=True))

    def jv(v: Params) -> torch.Tensor:
        return torch.autograd.grad(g_u, u, tuple(v), retain_graph=True)[0]

    r0 = r_graph.detach()
    return 0.5 * torch.sum(r0 * r0), jv, jt, jt(r0)


def _tmap(f, *trees):
    out = [f(*leaves) for leaves in zip(*trees)]
    t = trees[0]
    return type(t)(*out) if hasattr(t, "_fields") else tuple(out)


def _tdot(a, b) -> torch.Tensor:
    return sum(torch.sum(x * y) for x, y in zip(a, b))


def _make_spmd(mesh):
    """Reduction helpers of the sharded block branch (`mesh` given): tree
    dots all-reduce the voxel part and add the replicated globals' part once;
    `psum_globals` all-reduces a Params' global leaves (one collective),
    `psum_scalar` a tensor, `psum_g3` the three global cotangents. Without a
    mesh every helper is the single-device form."""
    if mesh is None:
        return _tdot, lambda p: p, lambda x: x, lambda *g: g

    def psum_g3(gp, gi, gd):
        k = gp.shape[0]
        flat = mesh.all_reduce(torch.cat([gp.reshape(-1), gi, gd]))
        return flat[: 6 * k].reshape(k, 6), flat[6 * k : 6 * k + 4], flat[6 * k + 4 :]

    def tdot(a, b):
        local = torch.sum(a.sdf * b.sdf) + torch.sum(a.albedo * b.albedo)
        rep = torch.sum(a.poses * b.poses) + torch.sum(a.intr * b.intr) + torch.sum(a.dist * b.dist)
        return mesh.all_reduce(local) + rep

    def psum_globals(p: Params) -> Params:
        return p._replace(**dict(zip(("poses", "intr", "dist"), psum_g3(p.poses, p.intr, p.dist))))

    return tdot, psum_globals, mesh.all_reduce, psum_g3


def _mask(m, v: Params) -> Params:
    return Params(*(mi * vi for mi, vi in zip(m, v)))


def _pcg(matvec, precond, b, iters: int, eta: float = 0.1, tdot=_tdot):
    """Preconditioned CG with the inexact-Newton exit of Ceres' CGNR: stop
    when ‖r‖ ≤ η·‖b‖ or after `iters` steps. Returns (x, steps_taken)."""
    x = _tmap(torch.zeros_like, b)
    r = b
    z = precond(r)
    p = z
    rz = tdot(r, z)
    tol2 = (eta * eta) * tdot(b, b)
    i = 0
    while i < iters:
        HOST_READS["pcg_residual"] += 1
        if not bool(tdot(r, r) > tol2):
            break
        ap = matvec(p)
        alpha = rz / torch.clamp(tdot(p, ap), min=1e-30)
        x = _tmap(lambda xi, pi: xi + alpha * pi, x, p)
        r = _tmap(lambda ri, api: ri - alpha * api, r, ap)
        z = precond(r)
        rz_new = tdot(r, z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = _tmap(lambda zi, pi: zi + beta * pi, z, p)
        rz = rz_new
        i += 1
    return x, i


def gn_iteration(
    params: Params,
    asm,
    masks: Masks,
    mu,
    lm_steps: int = 50,
    cg_iters: int = 12,
    cg_coeff_dtype: str = "bfloat16",
    schur_globals: bool = False,
    cg_eta: float = 0.1,
    eg_chunks: int = 1,
    device="cuda",
    mesh=None,
) -> Tuple[Params, torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """One relinearize→solve→accept cycle (``optimizer.cpp:119-173`` +
    ``nls_solver.cpp:296-337``) on a `blockform.BlockAssembly` or a
    flat-table `residuals.Assembly`.

    Block layout only, as in the JAX package: `cg_coeff_dtype` is the
    storage type of the E_g coefficient fields inside the PCG loop
    ("float32" for exact products; the gradient, the Jacobi diagonal, the
    residuals and every accumulation stay float32); `schur_globals`
    eliminates the global block; `eg_chunks > 1` streams the E_g
    linearization and the LM acceptance cost over that many frame chunks:
    only the coefficient fields, in `cg_coeff_dtype`, persist through the
    PCG, and the gradient, diagonal and global Gram are taken from those
    cast fields (float32-accumulated); one-shot takes them from the float32
    fields. The flat table runs exact products and the joint PCG.

    `mesh` runs the block branch on this rank's brick of a sharded problem
    (module docstring); `params`, `asm` and `masks` are then the rank's
    (`parallel.spmd.place_spmd_problem`, `SpmdLevel`).

    Returns (params', cost_before, cost_after, mu', num_tries)."""
    dev = resolve_device(device)
    mu = torch.as_tensor(mu, dtype=torch.float32, device=dev)
    tdot, psum_globals, psum_scalar, psum_g3 = _make_spmd(mesh)
    if mesh is not None and not isinstance(asm, blockform.BlockAssembly):
        raise ValueError("gn_iteration(mesh=...) runs the block layout only")
    if isinstance(asm, blockform.BlockAssembly):
        check_on(
            dev, sdf=params.sdf, poses=params.poses, eg_w=asm.eg_w, mask=masks.sdf,
            sdf_plan_nbr=asm.sdf_plan.nbr, alb_plan_nbr=asm.alb_plan.nbr,
        )
        chunked = eg_chunks > 1
        with span("solve.assemble"):
            if chunked:
                cost0, lin = blockform.linearize_block_chunked(params, asm, eg_chunks, getattr(torch, cg_coeff_dtype))
            else:
                cost0, lin = blockform.linearize_block(params, asm)
            cost0 = psum_scalar(cost0)
            grad = psum_globals(blockform.jtv_block(lin, asm, (lin.r0_g, lin.r0_r, lin.r0_s, lin.r0_a)))
            diag = psum_globals(blockform.diag_from_lin(lin, asm))
            if not chunked and cg_coeff_dtype != "float32":
                lin = blockform.cast_lin(lin, getattr(torch, cg_coeff_dtype))

        def normal_apply(v):
            return psum_globals(blockform.jtv_block(lin, asm, blockform.jv_block(lin, asm, v)))

        def cost_of(cand):
            return psum_scalar(blockform.block_total_cost(cand, asm, eg_chunks))

    else:
        check_on(dev, sdf=params.sdf, poses=params.poses, eg_w=asm.eg_w, er_idx=asm.er_idx, mask=masks.sdf)
        schur_globals = False  # the flat table runs the joint PCG (JAX: block path only)
        with span("solve.assemble"):
            cost0, jv, jt, grad = linearize_flat(params, asm)
            diag = jtj_diag(params, asm)

        def normal_apply(v):
            return jt(jv(v))

        def cost_of(cand):
            with torch.no_grad():
                return total_cost(cand, asm)

    # auto-fix parameters that appear in no residual (zero Jacobian column)
    masks = Params(*(m * (d > 0.0) for m, d in zip(masks, diag)))
    b = _mask(masks, _tmap(lambda g: -g, grad))

    def lm_pred(delta, mu):
        # LM model reduction ½·δᵀ(μDδ − g) for the gain ratio
        return 0.5 * (tdot(delta, b) + mu * tdot(delta, _tmap(lambda d_, v: d_ * v, diag, delta)))

    if schur_globals:
        k = params.poses.shape[0]
        C = psum_scalar(blockform.global_gram(lin))
        mg = blockform.flatten_globals(masks.poses, masks.intr, masks.dist)
        dg = blockform.flatten_globals(diag.poses, diag.intr, diag.dist)
        bg = blockform.flatten_globals(b.poses, b.intr, b.dist)
        zerog = (torch.zeros_like(params.poses), torch.zeros_like(params.intr), torch.zeros_like(params.dist))

        def try_step(mu):
            # damped global Gram, fixed dims pinned to identity
            Ct = mg[:, None] * (C + mu * torch.diag(dg)) * mg[None, :]
            Ct = Ct + torch.diag(torch.where(mg > 0.0, 1e-12, 1.0))
            chol_g, info = torch.linalg.cholesky_ex(Ct)
            # a failed factorization gives NaN, as jnp.linalg.cholesky does:
            # the try is then rejected on its non-finite cost
            chol_g = torch.where(info == 0, chol_g, torch.full_like(chol_g, float("nan")))

            def csolve(z):
                zc = (mg * z)[:, None]
                u = torch.linalg.solve_triangular(chol_g, zc, upper=False)
                u = torch.linalg.solve_triangular(chol_g.T, u, upper=True)
                return mg * u[:, 0]

            def reduced_apply(vs, va):
                y_g, y_r, y_s, y_a = blockform.jv_block(lin, asm, Params(vs, va, *zerog), include_globals=False)
                z = blockform.flatten_globals(*psum_g3(*blockform.jgt_apply(lin, y_g)))
                up, ui, ud = blockform.unflatten_globals(csolve(z), k)
                y_g2 = y_g - blockform.jg_apply(lin, up, ui, ud)
                out = blockform.jtv_block(lin, asm, (y_g2, y_r, y_s, y_a), include_globals=False)
                return out.sdf, out.albedo

            # reduced rhs: bᵥ − B·C̃⁻¹·b_g   (B·y = Jᵥᵀ(J_g y), E_g rows only)
            y0 = blockform.jg_apply(lin, *blockform.unflatten_globals(csolve(bg), k))
            corr = blockform.jtv_block(
                lin,
                asm,
                (y0, torch.zeros_like(lin.r0_r), torch.zeros_like(lin.r0_s), torch.zeros_like(lin.r0_a)),
                include_globals=False,
            )
            b2 = (masks.sdf * (b.sdf - corr.sdf), masks.albedo * (b.albedo - corr.albedo))

            def matvec(v2):
                vs = masks.sdf * v2[0]
                va = masks.albedo * v2[1]
                hs, ha = reduced_apply(vs, va)
                hs = hs + mu * diag.sdf * vs
                ha = ha + mu * diag.albedo * va
                return (
                    masks.sdf * hs + (1.0 - masks.sdf) * v2[0],
                    masks.albedo * ha + (1.0 - masks.albedo) * v2[1],
                )

            def precond(r2):
                return tuple(
                    mi * ri / (di * (1.0 + mu) + 1e-12) + (1.0 - mi) * ri
                    for ri, di, mi in zip(r2, (diag.sdf, diag.albedo), (masks.sdf, masks.albedo))
                )

            def tdot2(a2, c2):
                return psum_scalar(torch.sum(a2[0] * c2[0]) + torch.sum(a2[1] * c2[1]))

            (ds, da), _ = _pcg(matvec, precond, b2, cg_iters, eta=cg_eta, tdot=tdot2)
            ds = masks.sdf * ds
            da = masks.albedo * da
            # back-substitution: δ_g = C̃⁻¹(b_g − J_gᵀ Jᵥ δᵥ)
            yv = blockform.jv_block(lin, asm, Params(ds, da, *zerog), include_globals=False)[0]
            zv = blockform.flatten_globals(*psum_g3(*blockform.jgt_apply(lin, yv)))
            dp, di_, dd = blockform.unflatten_globals(csolve(bg - zv), k)
            delta = Params(ds, da, dp, di_, dd)
            cand = _tmap(lambda p, d: p + d, params, delta)
            return cand, cost_of(cand), lm_pred(delta, mu)

    else:

        def try_step(mu):
            def matvec(v):
                vm = _mask(masks, v)
                jj = normal_apply(vm)
                damped = _tmap(lambda h, d, vi: h + mu * d * vi, jj, diag, vm)
                return _tmap(lambda dm, mi, vi: mi * dm + (1.0 - mi) * vi, damped, masks, v)

            def precond(r):
                return _tmap(
                    lambda ri, di, mi: mi * ri / (di * (1.0 + mu) + 1e-12) + (1.0 - mi) * ri,
                    r, diag, masks,
                )

            delta, _ = _pcg(matvec, precond, b, cg_iters, eta=cg_eta, tdot=tdot)
            delta = _mask(masks, delta)
            cand = _tmap(lambda p, d: p + d, params, delta)
            return cand, cost_of(cand), lm_pred(delta, mu)

    tries, accepted = 0, False
    nu = torch.tensor(2.0, device=dev)
    out_params, cost1 = params, cost0
    while not accepted and tries < lm_steps:
        with span("solve.lm_try"):
            cand, cost, pred = try_step(mu)
            HOST_READS["lm_acceptance"] += 1
            accepted = bool(cost < cost0)
        # Ceres' Levenberg-Marquardt trust-region update
        # (``levenberg_marquardt_strategy.cc``): on accept the damping is
        # scaled by max(1/3, 1 − (2ρ−1)³) with the gain ratio ρ = actual /
        # model cost reduction (clipped at 2); on reject it grows by the
        # doubling ν.
        rho = (cost0 - cost) / torch.clamp(pred, min=1e-30)
        decay = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0, 2.0)
        if accepted:
            out_params, cost1 = cand, cost
            mu = torch.clamp(mu * decay, min=1e-10)
            nu = torch.tensor(2.0, device=dev)
        else:
            mu = torch.clamp(mu * nu, max=1e8)
            nu = torch.clamp(nu * 2.0, max=64.0)
        tries += 1
    return out_params, cost0, cost1, mu, tries
