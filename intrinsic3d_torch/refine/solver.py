"""Damped Gauss-Newton step with matrix-free PCG (block-dense layout).

Counterpart of the block branch of `intrinsic3d_tpu/refine/solver.py`,
replacing Ceres (``nls_solver.cpp``): Levenberg-Marquardt on the normal
equations with an exact Jacobi preconditioner, solved by PCG to the
inexact-Newton forcing tolerance η, stopping after the first successful step
so the outer loop re-collects observations (``nls_solver.cpp:279-293``).
With `schur_globals=True` the dense global block {poses, intrinsics,
distortion} is eliminated exactly through its damped [G, G] Gram matrix and
the PCG runs on the voxel space only.

The PCG and LM loops run on the host: each PCG step reads its residual norm
and each LM try its acceptance, one device→host sync each (at most
lm_steps × (cg_iters + 1) per call).

Not in this slice: the flat-table branch (`jax.linearize` of the residual
stack, `jtj_diag`), `eg_chunks > 1` and the SPMD `axis_name` mode.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from intrinsic3d_torch.device import check_on, resolve_device
from intrinsic3d_torch.refine import blockform
from intrinsic3d_torch.refine.residuals import Params


class Masks(NamedTuple):
    """0/1 free-parameter masks, same structure as Params."""

    sdf: torch.Tensor
    albedo: torch.Tensor
    poses: torch.Tensor
    intr: torch.Tensor
    dist: torch.Tensor


def _tmap(f, *trees):
    out = [f(*leaves) for leaves in zip(*trees)]
    t = trees[0]
    return type(t)(*out) if hasattr(t, "_fields") else tuple(out)


def _tdot(a, b) -> torch.Tensor:
    return sum(torch.sum(x * y) for x, y in zip(a, b))


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
    while i < iters and bool(tdot(r, r) > tol2):
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
    asm: blockform.BlockAssembly,
    masks: Masks,
    mu,
    lm_steps: int = 50,
    cg_iters: int = 12,
    cg_coeff_dtype: str = "bfloat16",
    schur_globals: bool = False,
    cg_eta: float = 0.1,
    device="cuda",
) -> Tuple[Params, torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """One relinearize→solve→accept cycle (``optimizer.cpp:119-173`` +
    ``nls_solver.cpp:296-337``) on the block-dense problem.

    `cg_coeff_dtype` is the storage type of the E_g coefficient fields inside
    the PCG loop ("float32" for exact products); the gradient, the Jacobi
    diagonal, the residuals and every accumulation stay float32.

    Returns (params', cost_before, cost_after, mu', num_tries)."""
    dev = resolve_device(device)
    check_on(
        dev, sdf=params.sdf, poses=params.poses, eg_w=asm.eg_w, mask=masks.sdf,
        sdf_plan_nbr=asm.sdf_plan.nbr, alb_plan_nbr=asm.alb_plan.nbr,
    )
    mu = torch.as_tensor(mu, dtype=torch.float32, device=dev)
    cost0, lin = blockform.linearize_block(params, asm)
    grad = blockform.jtv_block(lin, asm, (lin.r0_g, lin.r0_r, lin.r0_s, lin.r0_a))
    diag = blockform.diag_from_lin(lin, asm)
    if cg_coeff_dtype != "float32":
        lin = blockform.cast_lin(lin, getattr(torch, cg_coeff_dtype))
    # auto-fix parameters that appear in no residual (zero Jacobian column)
    masks = Params(*(m * (d > 0.0) for m, d in zip(masks, diag)))
    b = _mask(masks, _tmap(lambda g: -g, grad))

    def cost_of(cand):
        r = blockform.block_all_residuals(cand, asm)
        return 0.5 * torch.sum(r * r)

    def lm_pred(delta, mu):
        # LM model reduction ½·δᵀ(μDδ − g) for the gain ratio
        return 0.5 * (_tdot(delta, b) + mu * _tdot(delta, _tmap(lambda d_, v: d_ * v, diag, delta)))

    if schur_globals:
        k = params.poses.shape[0]
        C = blockform.global_gram(lin)
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
                z = blockform.flatten_globals(*blockform.jgt_apply(lin, y_g))
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

            (ds, da), _ = _pcg(matvec, precond, b2, cg_iters, eta=cg_eta)
            ds = masks.sdf * ds
            da = masks.albedo * da
            # back-substitution: δ_g = C̃⁻¹(b_g − J_gᵀ Jᵥ δᵥ)
            yv = blockform.jv_block(lin, asm, Params(ds, da, *zerog), include_globals=False)[0]
            zv = blockform.flatten_globals(*blockform.jgt_apply(lin, yv))
            dp, di_, dd = blockform.unflatten_globals(csolve(bg - zv), k)
            delta = Params(ds, da, dp, di_, dd)
            cand = _tmap(lambda p, d: p + d, params, delta)
            return cand, cost_of(cand), lm_pred(delta, mu)

    else:

        def try_step(mu):
            def matvec(v):
                vm = _mask(masks, v)
                jj = blockform.jtv_block(lin, asm, blockform.jv_block(lin, asm, vm))
                damped = _tmap(lambda h, d, vi: h + mu * d * vi, jj, diag, vm)
                return _tmap(lambda dm, mi, vi: mi * dm + (1.0 - mi) * vi, damped, masks, v)

            def precond(r):
                return _tmap(
                    lambda ri, di, mi: mi * ri / (di * (1.0 + mu) + 1e-12) + (1.0 - mi) * ri,
                    r, diag, masks,
                )

            delta, _ = _pcg(matvec, precond, b, cg_iters, eta=cg_eta)
            delta = _mask(masks, delta)
            cand = _tmap(lambda p, d: p + d, params, delta)
            return cand, cost_of(cand), lm_pred(delta, mu)

    tries, accepted = 0, False
    nu = torch.tensor(2.0, device=dev)
    out_params, cost1 = params, cost0
    while not accepted and tries < lm_steps:
        cand, cost, pred = try_step(mu)
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
