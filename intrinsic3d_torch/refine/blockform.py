"""Block-dense formulation of the joint-refinement problem (flat [nb, B³]).

Counterpart of the dense (`bmap is None`) part of
`intrinsic3d_tpu/refine/blockform.py`. Per-voxel fields live as
`[nb+1, B³]` blocks; stencil offsets are `grid.blocks.ShiftPlan` gathers;
E_r / E_s / E_a are evaluated densely over all block slots with per-slot
weights (E_a as three +axis direction fields); E_g is evaluated densely over
FRAME-MAJOR (keyframe k, block b, slot s) elements `[K, nb, B³]` — element
(k, b, s) is the observation of block b's voxel s by keyframe k, weight 0
where k is not among the voxel's top-N observations — so the frame index of
an element is its row index, the pose "gather" a broadcast of `poses[k]` and
its transpose a per-row sum.

`linearize_block` takes the exact per-element E_g Jacobian from ONE reverse
pass with a ones cotangent (elements are independent); the GN matvec, its
transpose, the gradient and the Jacobi diagonal are then dense elementwise
math over the coefficient fields plus shift-plan gathers.

Not in this slice: frame buckets (`bmap`), the streamed
`linearize_block_chunked`/`block_total_cost`, the frame-bucket construction and
the flat-table bridge `to_block_problem`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from intrinsic3d_torch.device import resolve_device
from intrinsic3d_torch.grid.blocks import BlockLayout, ShiftPlan, build_shift_plan, pad_flat
from intrinsic3d_torch.grid.voxel_grid import EG_ALBEDO_OFFSETS, EG_SDF_OFFSETS
from intrinsic3d_torch.refine.residuals import Params, eg_core

# sdf plan: the 10 E_g forward-difference offsets + the three −axis offsets
# (completing the ±6-ring of the E_r Laplacian and its diagonal)
SDF_OFFSETS = tuple(map(tuple, EG_SDF_OFFSETS.tolist())) + ((-1, 0, 0), (0, -1, 0), (0, 0, -1))
# albedo plan: E_g's 4 albedo taps + the three −axis offsets (E_a diagonal)
ALB_OFFSETS = tuple(map(tuple, EG_ALBEDO_OFFSETS.tolist())) + ((-1, 0, 0), (0, -1, 0), (0, 0, -1))

_PLUS = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
_RING6 = _PLUS + ((-1, 0, 0), (0, -1, 0), (0, 0, -1))


class BlockAssembly(NamedTuple):
    """Per-outer-iteration problem data in flat block-dense layout."""

    eg_w: torch.Tensor  # [K, nb, B³] observation·shell weight (0 = inactive)
    eg_sh: torch.Tensor  # [9, D] per-voxel SH coefficients (D = nb·B³)
    eg_vpos: torch.Tensor  # [3, D] int32 voxel coords (0 on empty slots)
    sdf_plan: ShiftPlan
    alb_plan: ShiftPlan
    er_w: torch.Tensor  # [nb, B³]
    es_ref: torch.Tensor  # [nb, B³]
    es_w: torch.Tensor  # [nb, B³]
    ea_w: torch.Tensor  # [3, nb, B³] weight of pair (v, v + e_d)
    lam: torch.Tensor  # [4] normalized λ̃ for (E_g, E_r, E_s, E_a)
    images: torch.Tensor  # [K, H, W]
    pyr_scale: torch.Tensor
    voxel_size: torch.Tensor


def _fid_rows(k: int, kb: int, s: int, device) -> torch.Tensor:
    """Per-element keyframe index of the frame-major layout: the row index."""
    return torch.arange(k, dtype=torch.int32, device=device).view(k, 1, 1).expand(k, kb, s)


def _perslot(field: torch.Tensor, k: int, kb: int, s: int) -> torch.Tensor:
    """Per-slot `[C, nb·B³]` field → broadcast per-element rows [K, nb, B³, C]."""
    c = field.shape[0]
    return field.reshape(c, kb, s).movedim(0, -1).unsqueeze(0).expand(k, kb, s, c)


def _eg_dense(poses_intr_dist, sdf10, alb4, asm: BlockAssembly, validity_only=False, masked=False):
    """Dense E_g forward over the (keyframe, slot) elements: weighted `[K, nb, B³]`."""
    poses, intr, dist = poses_intr_dist
    k, kb, s = asm.eg_w.shape
    r = eg_core(
        sdf10,
        alb4,
        poses.view(k, 1, 1, 6).expand(k, kb, s, 6),
        intr,
        dist,
        _perslot(asm.eg_sh, k, kb, s),
        _perslot(asm.eg_vpos, k, kb, s),
        _fid_rows(k, kb, s, asm.eg_w.device),
        asm.images,
        asm.pyr_scale,
        asm.voxel_size,
        validity_only=validity_only,
        active=(asm.eg_w > 0).to(torch.float32) if masked else None,
    )
    return torch.sqrt(asm.eg_w * asm.lam[0]) * r


def _stencil_for(asm: BlockAssembly, sh: torch.Tensor, t: int) -> torch.Tensor:
    """`[T', nb, B³]` shifted stack → broadcast per-element rows [K, nb, B³, t]."""
    k = asm.eg_w.shape[0]
    return sh[:t].movedim(0, -1).unsqueeze(0).expand(k, *sh.shape[1:], t)


def _linear_terms(sh, sha, asm: BlockAssembly):
    """E_r / E_s / E_a residuals and their √(w·λ) factors (closed-form
    Jacobians): (r_r, r_s, r_a, sq_er, sq_es, sq_ea)."""
    c = asm.sdf_plan.index((0, 0, 0))
    center = sh[c]
    lap = -6.0 * center
    for off in _RING6:
        lap = lap + sh[asm.sdf_plan.index(off)]
    sq_er = torch.sqrt(asm.er_w * asm.lam[1])
    sq_es = torch.sqrt(asm.es_w * asm.lam[2])
    sq_ea = torch.sqrt(asm.ea_w * asm.lam[3])
    a_c = sha[asm.alb_plan.index((0, 0, 0))]
    r_a = torch.stack(
        [sq_ea[dd] * (a_c - sha[asm.alb_plan.index(e)]) for dd, e in enumerate(_PLUS)]
    )
    return sq_er * lap, sq_es * (center - asm.es_ref), r_a, sq_er, sq_es, sq_ea


def block_all_residuals(params: Params, asm: BlockAssembly, masked: bool = True) -> torch.Tensor:
    """Concatenated weighted residual vector (E_g rows in dense (keyframe,
    slot) order with zero rows for inactive elements, then E_r, E_s, E_a).
    `masked` passes the E_g weight mask to the sampler (inactive elements
    are not sampled)."""
    sh = asm.sdf_plan.apply(params.sdf)  # [13, nb, B³]
    sha = asm.alb_plan.apply(params.albedo)  # [7, nb, B³]
    r_g = _eg_dense(
        (params.poses, params.intr, params.dist),
        _stencil_for(asm, sh, 10),
        _stencil_for(asm, sha, 4),
        asm,
        masked=masked,
    ).reshape(-1)
    r_r, r_s, r_a, _, _, _ = _linear_terms(sh, sha, asm)
    return torch.cat([r_g, r_r.reshape(-1), r_s.reshape(-1)] + [ra.reshape(-1) for ra in r_a])


# ---------------------------------------------------------------------------
# Hand-rolled linearization
# ---------------------------------------------------------------------------


class BlockLin(NamedTuple):
    """Linearization of the block problem at a point (static through PCG)."""

    a_sdf: torch.Tensor  # [10, K, nb, B³]
    a_alb: torch.Tensor  # [4, K, nb, B³]
    a_pose: torch.Tensor  # [6, K, nb, B³]
    a_intr: torch.Tensor  # [4, K, nb, B³]
    a_dist: torch.Tensor  # [5, K, nb, B³]
    r0_g: torch.Tensor  # [K, nb, B³] weighted E_g residual
    r0_r: torch.Tensor  # [nb, B³]
    r0_s: torch.Tensor  # [nb, B³]
    r0_a: torch.Tensor  # [3, nb, B³]
    sq_er: torch.Tensor  # [nb, B³] √(w·λ) factors (Jacobians of the linear terms)
    sq_es: torch.Tensor  # [nb, B³]
    sq_ea: torch.Tensor  # [3, nb, B³]


def _ring_into(plan: ShiftPlan, cot: list, center_val, ring_val) -> None:
    """Accumulate a Laplacian-shaped cotangent: center_val at the center,
    ring_val at the ±axes."""
    c = plan.index((0, 0, 0))
    cot[c] = cot[c] + center_val
    for o in _RING6:
        cot[plan.index(o)] = cot[plan.index(o)] + ring_val


def linearize_block(params: Params, asm: BlockAssembly) -> Tuple[torch.Tensor, BlockLin]:
    """One reverse pass over the dense E_g elements + closed forms for the
    linear terms. Returns (cost0, lin).

    The per-element inputs are materialized coefficient-major (`[C, K, nb,
    B³]`) and fed to `eg_core` as `[..., C]` views, so the ones-cotangent
    gradients land directly in BlockLin's layout. The autograd graph is freed
    by the `autograd.grad` call itself (no `retain_graph`)."""
    k, kb, s = asm.eg_w.shape
    sh = asm.sdf_plan.apply(params.sdf)  # [13, nb, B³]
    sha = asm.alb_plan.apply(params.albedo)  # [7, nb, B³]

    def leaf(src):
        # per-slot [c, nb, B³], per-frame [c, K] or shared [c] values → a
        # materialized [c, K, nb, B³] input of the reverse pass
        src = src.detach()
        src = src[:, None] if src.dim() == 3 else src.reshape(src.shape[0], -1, 1, 1)
        return src.expand(src.shape[0], k, kb, s).clone().requires_grad_(True)

    inputs = (leaf(sh[:10]), leaf(sha[:4]), leaf(params.poses.T), leaf(params.intr), leaf(params.dist))
    sqrt_wlam = torch.sqrt(asm.eg_w * asm.lam[0])
    with torch.enable_grad():
        r0_g = sqrt_wlam * eg_core(
            *(a.movedim(0, -1) for a in inputs),
            _perslot(asm.eg_sh, k, kb, s),
            _perslot(asm.eg_vpos, k, kb, s),
            _fid_rows(k, kb, s, asm.eg_w.device),
            asm.images,
            asm.pyr_scale,
            asm.voxel_size,
            active=(asm.eg_w > 0).to(torch.float32),
        )
        # elements are independent: a ones cotangent gives the exact
        # per-element Jacobian, directly in the coefficient-major layout
        a_sdf, a_alb, a_pose, a_intr, a_dist = torch.autograd.grad(
            r0_g, inputs, grad_outputs=torch.ones_like(r0_g)
        )
    r0_g = r0_g.detach()

    r0_r, r0_s, r0_a, sq_er, sq_es, sq_ea = _linear_terms(sh, sha, asm)
    cost0 = 0.5 * (
        torch.sum(r0_g * r0_g)
        + torch.sum(r0_r * r0_r)
        + torch.sum(r0_s * r0_s)
        + torch.sum(r0_a * r0_a)
    )
    lin = BlockLin(a_sdf, a_alb, a_pose, a_intr, a_dist, r0_g, r0_r, r0_s, r0_a, sq_er, sq_es, sq_ea)
    return cost0, lin


def cast_lin(lin: BlockLin, dtype) -> BlockLin:
    """Cast the dense E_g coefficient fields (the PCG matvec's dominant
    memory traffic, 29 × [K, D]) to `dtype`; residuals and the linear-term
    factors stay float32. `jv_block`/`jtv_block` read the same cast fields,
    so the J/Jᵀ pair stays exactly adjoint."""
    return lin._replace(
        a_sdf=lin.a_sdf.to(dtype),
        a_alb=lin.a_alb.to(dtype),
        a_pose=lin.a_pose.to(dtype),
        a_intr=lin.a_intr.to(dtype),
        a_dist=lin.a_dist.to(dtype),
    )


def _f32(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.float32)


def jv_block(lin: BlockLin, asm: BlockAssembly, v: Params, include_globals: bool = True):
    """J·v — the tangent of the residual parts (y_g, y_r, y_s, y_a).

    Products of (possibly bf16) coefficients with float32 vectors are taken in
    float32, as JAX promotes them. `include_globals=False` skips the
    pose/intr/dist tangents (the Schur-reduced matvec's voxel-only tangent)."""
    sh = asm.sdf_plan.apply(v.sdf)
    sha = asm.alb_plan.apply(v.albedo)
    y_g = torch.sum(lin.a_sdf * sh[:10].unsqueeze(1), dim=0)
    y_g = y_g + torch.sum(lin.a_alb * sha[:4].unsqueeze(1), dim=0)
    if include_globals:
        y_g = y_g + jg_apply(lin, v.poses, v.intr, v.dist)

    c = asm.sdf_plan.index((0, 0, 0))
    lap = -6.0 * sh[c]
    for off in _RING6:
        lap = lap + sh[asm.sdf_plan.index(off)]
    y_r = lin.sq_er * lap
    y_s = lin.sq_es * sh[c]
    a_c = sha[asm.alb_plan.index((0, 0, 0))]
    y_a = torch.stack(
        [lin.sq_ea[dd] * (a_c - sha[asm.alb_plan.index(e)]) for dd, e in enumerate(_PLUS)]
    )
    return (y_g, y_r, y_s, y_a)


def jtv_block(lin: BlockLin, asm: BlockAssembly, y, include_globals: bool = True) -> Params:
    """Jᵀ·y — the exact adjoint of `jv_block`. `include_globals=False`
    returns zero global cotangents without reading their coefficient fields."""
    y_g, y_r, y_s, y_a = y
    nb, s = lin.r0_r.shape
    zeros = lambda: y_g.new_zeros(nb, s)  # noqa: E731

    q = torch.sum(lin.a_sdf * y_g.unsqueeze(0), dim=1)  # [10, nb, B³]
    cot = [q[j] for j in range(10)] + [zeros() for _ in range(len(asm.sdf_plan.offsets) - 10)]
    yr = lin.sq_er * y_r
    _ring_into(asm.sdf_plan, cot, -6.0 * yr, yr)
    c = asm.sdf_plan.index((0, 0, 0))
    cot[c] = cot[c] + lin.sq_es * y_s
    g_sdf = asm.sdf_plan.apply_transpose(torch.stack(cot))

    qa = torch.sum(lin.a_alb * y_g.unsqueeze(0), dim=1)  # [4, nb, B³]
    cot_a = [qa[j] for j in range(4)] + [zeros() for _ in range(len(asm.alb_plan.offsets) - 4)]
    ca = asm.alb_plan.index((0, 0, 0))
    for dd, e in enumerate(_PLUS):
        ya = lin.sq_ea[dd] * y_a[dd]
        cot_a[ca] = cot_a[ca] + ya
        ei = asm.alb_plan.index(e)
        cot_a[ei] = cot_a[ei] - ya
    g_alb = asm.alb_plan.apply_transpose(torch.stack(cot_a))

    if not include_globals:
        k = lin.a_pose.shape[1]
        return Params(g_sdf, g_alb, g_sdf.new_zeros(k, 6), g_sdf.new_zeros(4), g_sdf.new_zeros(5))
    return Params(g_sdf, g_alb, *jgt_apply(lin, y_g))


def diag_from_lin(lin: BlockLin, asm: BlockAssembly) -> Params:
    """Exact diag(JᵀJ) from the coefficient fields, squares accumulated in
    float32 even when the fields are bf16."""
    nb, s = lin.r0_r.shape
    asq = _f32(lin.a_sdf)
    aasq = _f32(lin.a_alb)

    q2 = torch.sum(asq * asq, dim=1)  # [10, nb, B³]
    cot = [q2[j] for j in range(10)] + [
        q2.new_zeros(nb, s) for _ in range(len(asm.sdf_plan.offsets) - 10)
    ]
    wl_r = lin.sq_er * lin.sq_er
    _ring_into(asm.sdf_plan, cot, 36.0 * wl_r, wl_r)
    c = asm.sdf_plan.index((0, 0, 0))
    cot[c] = cot[c] + lin.sq_es * lin.sq_es
    d_sdf = asm.sdf_plan.apply_transpose(torch.stack(cot))

    qa2 = torch.sum(aasq * aasq, dim=1)  # [4, nb, B³]
    cot_a = [qa2[j] for j in range(4)] + [
        qa2.new_zeros(nb, s) for _ in range(len(asm.alb_plan.offsets) - 4)
    ]
    ca = asm.alb_plan.index((0, 0, 0))
    wl_a = lin.sq_ea * lin.sq_ea
    cot_a[ca] = cot_a[ca] + torch.sum(wl_a, dim=0)
    for dd, e in enumerate(_PLUS):
        ei = asm.alb_plan.index(e)
        cot_a[ei] = cot_a[ei] + wl_a[dd]
    d_alb = asm.alb_plan.apply_transpose(torch.stack(cot_a))

    psq = _f32(lin.a_pose)
    isq = _f32(lin.a_intr)
    dsq = _f32(lin.a_dist)
    d_pose = torch.sum(psq * psq, dim=(2, 3)).T  # [K, 6]
    d_intr = torch.sum(isq * isq, dim=(1, 2, 3))
    d_dist = torch.sum(dsq * dsq, dim=(1, 2, 3))
    return Params(d_sdf, d_alb, d_pose, d_intr, d_dist)


# ---------------------------------------------------------------------------
# Schur complement of the global block (poses, intrinsics, distortion)
# ---------------------------------------------------------------------------
#
# The globals span G = 6K+9 dims whose J columns are dense over every E_g
# element. The elimination folds into the cotangent before the stencil
# transpose — S·x = Jᵥᵀ(Jᵥx − J_g·C̃⁻¹·J_gᵀ·Jᵥx) + μDᵥx — so the reduced
# matvec costs one J/Jᵀ pair plus G-sized contractions and a [G, G]
# triangular solve.


def flatten_globals(p_pose, p_intr, p_dist) -> torch.Tensor:
    """(K·6, 4, 5) global leaves → one [G] vector (pose-major)."""
    return torch.cat([p_pose.reshape(-1), p_intr, p_dist])


def unflatten_globals(g: torch.Tensor, k: int):
    return g[: 6 * k].reshape(k, 6), g[6 * k : 6 * k + 4], g[6 * k + 4 :]


def global_gram(lin: BlockLin) -> torch.Tensor:
    """Dense `C = J_gᵀ J_g` `[G, G]` from the (possibly bf16) coefficient
    fields, accumulated in float32. Frame-major rows make the pose-pose part
    block-diagonal per frame.

    The 15 global fields' Gram is taken per (frame, block) — K·nb batched
    15×15 products over a block's B³ lanes — and then summed over blocks:
    one contraction over all K·nb·B³ elements would give the card a handful
    of output tiles to work on."""
    k, nb, s = lin.a_pose.shape[1:]
    a = torch.cat([_f32(lin.a_pose), _f32(lin.a_intr), _f32(lin.a_dist)])  # [15, K, nb, B³]
    rows = a.permute(1, 2, 0, 3).reshape(k * nb, 15, s)
    per_frame = torch.bmm(rows, rows.transpose(1, 2)).view(k, nb, 15, 15).sum(dim=1)  # [K, 15, 15]
    c_pg = per_frame[:, :6, 6:]  # pose × (intr, dist), per frame
    c_gg = per_frame[:, 6:, 6:].sum(dim=0)  # (intr, dist) × (intr, dist) over all frames

    g = 6 * k + 9
    C = a.new_zeros(g, g)
    C[: 6 * k, : 6 * k] = torch.block_diag(*per_frame[:, :6, :6])
    C[: 6 * k, 6 * k :] = c_pg.reshape(6 * k, 9)
    C[6 * k :, : 6 * k] = c_pg.reshape(6 * k, 9).T
    C[6 * k :, 6 * k :] = c_gg
    return C


def jg_apply(lin: BlockLin, g_pose, g_intr, g_dist) -> torch.Tensor:
    """`J_g · v_g` on the E_g rows — `[K, nb, B³]` (row k takes g_pose[k])."""
    y = torch.einsum("akbs,ka->kbs", _f32(lin.a_pose), g_pose)
    y = y + torch.einsum("akbs,a->kbs", _f32(lin.a_intr), g_intr)
    return y + torch.einsum("akbs,a->kbs", _f32(lin.a_dist), g_dist)


def jgt_apply(lin: BlockLin, y_g):
    """`J_gᵀ · y` restricted to the E_g rows — the global cotangents."""
    g_pose = torch.einsum("akbs,kbs->ka", _f32(lin.a_pose), y_g)
    g_intr = torch.einsum("akbs,kbs->a", _f32(lin.a_intr), y_g)
    g_dist = torch.einsum("akbs,kbs->a", _f32(lin.a_dist), y_g)
    return g_pose, g_intr, g_dist


# ---------------------------------------------------------------------------
# Table ⇄ block transport
# ---------------------------------------------------------------------------


def table_to_dense(layout: BlockLayout, table: torch.Tensor, pad: bool = True) -> torch.Tensor:
    """[N] table field → flat `[nb(+1), B³]` dense blocks (empty slots 0)."""
    s = layout.block**3
    slots = torch.as_tensor(layout.vox_slot, device=table.device)
    out = table.new_zeros(layout.num_blocks * s)
    out[slots] = table
    out = out.reshape(layout.num_blocks, s)
    return pad_flat(out) if pad else out


def dense_to_table(layout: BlockLayout, dense: torch.Tensor) -> torch.Tensor:
    """Flat dense blocks (padded or not) → [N] table order."""
    return dense.reshape(-1)[torch.as_tensor(layout.vox_slot, device=dense.device)]


def layout_plans(layout: BlockLayout, device="cuda") -> Tuple[ShiftPlan, ShiftPlan]:
    """The sdf/albedo shift plans of `layout` on `device` (cached on the layout)."""
    dev = resolve_device(device)
    cache = layout.__dict__.setdefault("_plan_cache", {})
    key = str(dev)
    if key not in cache:
        cache[key] = (
            build_shift_plan(layout, SDF_OFFSETS, dev),
            build_shift_plan(layout, ALB_OFFSETS, dev),
        )
    return cache[key]
