"""Block-dense formulation of the joint-refinement problem (flat [nb, B³]).

Counterpart of `intrinsic3d_tpu/refine/blockform.py`. Per-voxel fields live
as `[nb+1, B³]` blocks; stencil offsets are `grid.blocks.ShiftPlan` gathers;
E_r / E_s / E_a are evaluated densely over all block slots with per-slot
weights (E_a as three +axis direction fields); E_g is evaluated densely over
FRAME-MAJOR (keyframe k, block b, slot s) elements `[K, nb, B³]` — element
(k, b, s) is the observation of block b's voxel s by keyframe k, weight 0
where k is not among the voxel's top-N observations — so the frame index of
an element is its row index, the pose "gather" a broadcast of `poses[k]` and
its transpose a per-row sum.

With `BlockAssembly.bmap [K, NBc]` set (FRAME-BUCKETED elements, for captures
whose keyframe count far exceeds the per-voxel observation cap), row k holds
only the NBc blocks of frame k's visibility bucket (`build_frame_buckets`):
element (k, j, s) is the observation of block `bmap[k, j]`'s slot s. Every
per-element stencil and per-slot value is then a gather of whole 512-slot
block rows (`_gather_rows`), and every transpose a scatter-add of block rows
(`_unbucket`); padding entries equal nb and index the all-zero pad row.

`linearize_block` takes the exact per-element E_g Jacobian from ONE reverse
pass with a ones cotangent (elements are independent); the GN matvec, its
transpose, the gradient and the Jacobi diagonal are then elementwise math
over the coefficient fields plus shift-plan gathers.
`linearize_block_chunked` and `block_total_cost` stream that reverse pass
and the LM acceptance forward over frame chunks, so only the compact
coefficient fields persist while the transients are bounded at one chunk's
frames. On the card each of those E_g passes is one launch of the E_g
kernel a chunk (`ops.eg_rows`: the residual and its 29 coefficients written
into the fields, or the residual and its r² partial sums), with no autograd
and no element-sized transient; on the CPU they run `eg_core` eagerly and
its autograd reverse pass, the plain version the kernel is held to.
`EG_PASSES` counts the passes of each kind. `to_block_problem` re-lays a
flat-table problem (`refine.assembly.build_assembly`) into this form, the equivalence bridge of
the tests and of `chip_smoke.py`.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from intrinsic3d_torch.device import check_on, resolve_device
from intrinsic3d_torch.grid.blocks import BlockLayout, ShiftPlan, build_shift_plan, pad_flat
from intrinsic3d_torch.grid.voxel_grid import EG_ALBEDO_OFFSETS, EG_SDF_OFFSETS
from intrinsic3d_torch.mathutil import pose_vec_to_matrix
from intrinsic3d_torch.ops import eg_rows
from intrinsic3d_torch.refine.residuals import Assembly, Params, eg_core

log = logging.getLogger("intrinsic3d")

# sdf plan: the 10 E_g forward-difference offsets + the three −axis offsets
# (completing the ±6-ring of the E_r Laplacian and its diagonal)
SDF_OFFSETS = tuple(map(tuple, EG_SDF_OFFSETS.tolist())) + ((-1, 0, 0), (0, -1, 0), (0, 0, -1))
# albedo plan: E_g's 4 albedo taps + the three −axis offsets (E_a diagonal)
ALB_OFFSETS = tuple(map(tuple, EG_ALBEDO_OFFSETS.tolist())) + ((-1, 0, 0), (0, -1, 0), (0, 0, -1))

_PLUS = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
_RING6 = _PLUS + ((-1, 0, 0), (0, -1, 0), (0, 0, -1))

# E_g passes of the linearization and the LM acceptance cost, one a frame
# chunk: "fused" through the E_g kernel, "eager" through `eg_core` (and, to
# linearize, autograd). `OptimizeStats` keeps a level's difference.
EG_PASSES: Dict[str, int] = {"fused": 0, "eager": 0}

# depth pixels the level planner's min/max mips (`_depth_interval_mips`)
# scanned, counted on the thread that scanned them: a level plans on its
# `LevelPrep` thread or on its own (`OptimizeStats.plan_depth_px`)
_SCANNED = threading.local()


def depth_pixels_scanned() -> int:
    """Depth pixels `_depth_interval_mips` has scanned on the calling
    thread so far."""
    return getattr(_SCANNED, "pixels", 0)


class BlockAssembly(NamedTuple):
    """Per-outer-iteration problem data in flat block-dense layout."""

    eg_w: torch.Tensor  # [K, kb, B³] observation·shell weight (0 = inactive); kb = nb, or NBc bucketed
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
    bmap: Optional[torch.Tensor] = None  # [K, NBc] int64 frame buckets (pad = nb), or None (dense)


def _fid_rows(k: int, kb: int, s: int, device) -> torch.Tensor:
    """Per-element keyframe index of the frame-major layout: the row index."""
    return torch.arange(k, dtype=torch.int32, device=device).view(k, 1, 1).expand(k, kb, s)


def _perslot(field: torch.Tensor, k: int, kb: int, s: int) -> torch.Tensor:
    """Per-slot `[C, nb·B³]` field → broadcast per-element rows [K, nb, B³, C]."""
    c = field.shape[0]
    return field.reshape(c, kb, s).movedim(0, -1).unsqueeze(0).expand(k, kb, s, c)


# ---------------------------------------------------------------------------
# Frame-bucketed element transport (bmap is not None): whole 512-slot block
# rows are gathered and scatter-added, never single elements
# ---------------------------------------------------------------------------


def _pad_rows(stack: torch.Tensor) -> torch.Tensor:
    """`[T, nb, S]` → `[T, nb+1, S]` with an all-zero pad row (bmap target)."""
    return torch.cat([stack, stack.new_zeros(stack.shape[0], 1, stack.shape[2])], dim=1)


def _gather_rows(stack: torch.Tensor, bmap: torch.Tensor) -> torch.Tensor:
    """`[T, nb, S]` per-slot stack → coefficient-major bucketed rows
    `[T, K, NBc, S]`: one `index_select` of block rows from the stack padded
    once, in the layout the E_g core and the linearization read."""
    t, _, s = stack.shape
    k, nbc = bmap.shape
    return _pad_rows(stack).index_select(1, bmap.reshape(-1)).view(t, k, nbc, s)


def _stencil_bucket(sh: torch.Tensor, t: int, bmap: torch.Tensor) -> torch.Tensor:
    """`[T', nb, B³]` shifted stack → bucketed per-element rows [K, NBc, B³, t]
    (a view of the `[t, K, NBc, B³]` gather)."""
    return _gather_rows(sh[:t], bmap).movedim(0, -1)


def _perslot_bucket(field: torch.Tensor, bmap: torch.Tensor, s: int = 512) -> torch.Tensor:
    """Per-slot `[C, nb·B³]` field → bucketed per-element rows [K, NBc, B³, C]."""
    return _gather_rows(field.reshape(field.shape[0], -1, s), bmap).movedim(0, -1)


def _unbucket(vals: torch.Tensor, bmap: torch.Tensor, nb: int, s: int) -> torch.Tensor:
    """`[F, K, NBc, S]` bucketed cotangents → `[F, nb, S]` per-slot sums: one
    `index_add_` of K·NBc block rows (rows of one block from several frames
    accumulate; padding rows land on the dropped pad row). On the card the
    adds are atomic, so the sums' order, and their last bits, vary from run
    to run."""
    f, k, nbc = vals.shape[:3]
    out = vals.new_zeros(f, nb + 1, s)
    out.index_add_(1, bmap.reshape(-1), vals.reshape(f, k * nbc, s))
    return out[:, :nb]


def _eg_chunk_inputs(asm: BlockAssembly, sh, sha, eg_w, bmap, fids, poses, intr, dist):
    """Coefficient-major per-element inputs of the E_g core for the frame rows
    `fids [kc]` (int32, the true keyframe ids) with weights `eg_w [kc, kb,
    B³]` and, bucketed, their bucket rows `bmap [kc, NBc]`: the stencil and
    parameter stacks `(sdf10 [10, kc, kb, B³], alb4 [4, …], pose6 [6, …],
    intr4 [4, …], dist5 [5, …])`, then sh9 `[9, …]`, vpos `[3, …]` and the
    frame ids `[kc, kb, B³]`. Dense rows are broadcast views; bucketed rows
    are gathered copies."""
    kc, kb, s = eg_w.shape
    if bmap is None:
        def rows(x):  # [C, kb, B³] per-slot → broadcast [C, kc, kb, B³]
            return x.unsqueeze(1).expand(x.shape[0], kc, kb, s)
    else:
        def rows(x):
            return _gather_rows(x, bmap)
    per_frame = poses[fids.long()].T.reshape(6, kc, 1, 1).expand(6, kc, kb, s)
    stacks = (
        rows(sh[:10]),
        rows(sha[:4]),
        per_frame,
        intr.reshape(4, 1, 1, 1).expand(4, kc, kb, s),
        dist.reshape(5, 1, 1, 1).expand(5, kc, kb, s),
    )
    sh9 = rows(asm.eg_sh.reshape(9, -1, s))
    vpos = rows(asm.eg_vpos.reshape(3, -1, s))
    fid = fids.view(kc, 1, 1).expand(kc, kb, s)
    return stacks, sh9, vpos, fid


def _eg_dense(poses_intr_dist, sdf10, alb4, asm: BlockAssembly, validity_only=False, masked=False):
    """E_g forward over the (keyframe, slot or bucket) elements: weighted
    `[K, kb, B³]`."""
    poses, intr, dist = poses_intr_dist
    k, kb, s = asm.eg_w.shape
    if asm.bmap is None:
        sh9 = _perslot(asm.eg_sh, k, kb, s)
        vpos = _perslot(asm.eg_vpos, k, kb, s)
    else:
        sh9 = _perslot_bucket(asm.eg_sh, asm.bmap, s)
        vpos = _perslot_bucket(asm.eg_vpos, asm.bmap, s)
    r = eg_core(
        sdf10,
        alb4,
        poses.view(k, 1, 1, 6).expand(k, kb, s, 6),
        intr,
        dist,
        sh9,
        vpos,
        _fid_rows(k, kb, s, asm.eg_w.device),
        asm.images,
        asm.pyr_scale,
        asm.voxel_size,
        validity_only=validity_only,
        active=(asm.eg_w > 0).to(torch.float32) if masked else None,
    )
    return torch.sqrt(asm.eg_w * asm.lam[0]) * r


def _stencil_for(asm: BlockAssembly, sh: torch.Tensor, t: int) -> torch.Tensor:
    """`[T', nb, B³]` shifted stack → per-element rows [K, kb, B³, t] in the
    assembly's element layout (a broadcast dense, a gather bucketed)."""
    if asm.bmap is not None:
        return _stencil_bucket(sh, t, asm.bmap)
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


def _eg_reverse(asm: BlockAssembly, sh, sha, eg_w, bmap, fids, params: Params):
    """The weighted E_g residual of the frame rows `fids` and its exact
    per-element Jacobian from ONE reverse pass with a ones cotangent
    (elements are independent). The inputs are materialized
    coefficient-major (`[C, kc, kb, B³]`; a bucketed gather is already a
    fresh copy) and fed to `eg_core` as `[..., C]` views, so the gradients
    land in BlockLin's layout. `autograd.grad` frees the graph itself (no
    `retain_graph`). Returns (r0 `[kc, kb, B³]`, (a_sdf, a_alb, a_pose,
    a_intr, a_dist))."""
    EG_PASSES["eager"] += 1
    stacks, sh9, vpos, fid = _eg_chunk_inputs(asm, sh, sha, eg_w, bmap, fids, params.poses, params.intr, params.dist)
    inputs = tuple(x.detach().contiguous().requires_grad_(True) for x in stacks)
    sqrt_wlam = torch.sqrt(eg_w * asm.lam[0])
    with torch.enable_grad():
        r0 = sqrt_wlam * eg_core(
            *(a.movedim(0, -1) for a in inputs),
            sh9.movedim(0, -1),
            vpos.movedim(0, -1),
            fid,
            asm.images,
            asm.pyr_scale,
            asm.voxel_size,
            active=(eg_w > 0).to(torch.float32),
        )
        grads = torch.autograd.grad(r0, inputs, grad_outputs=torch.ones_like(r0))
    return r0.detach(), grads


def _finish_lin(sh, sha, asm: BlockAssembly, r0_g, coeffs) -> Tuple[torch.Tensor, BlockLin]:
    """Closed forms of the linear terms and the total cost around the E_g
    residual and coefficient fields: (cost0, lin)."""
    r0_r, r0_s, r0_a, sq_er, sq_es, sq_ea = _linear_terms(sh, sha, asm)
    cost0 = 0.5 * (
        torch.sum(r0_g * r0_g)
        + torch.sum(r0_r * r0_r)
        + torch.sum(r0_s * r0_s)
        + torch.sum(r0_a * r0_a)
    )
    return cost0, BlockLin(*coeffs, r0_g, r0_r, r0_s, r0_a, sq_er, sq_es, sq_ea)


def _frame_chunks(k: int, num_chunks: int) -> list:
    """`(first frame, frames)` of the ⌈K/C⌉-frame chunks of a K-frame
    element grid (`_chunk_xs` pads the last one; the E_g kernel takes any
    number of frame rows)."""
    kc = -(-k // max(num_chunks, 1))
    return [(lo, min(kc, k - lo)) for lo in range(0, k, kc)]


def _eg_inputs(asm: BlockAssembly, sh, sha, params: Params) -> eg_rows.EgRowsInputs:
    return eg_rows.EgRowsInputs(
        sdf=sh, alb=sha, sh=asm.eg_sh, vpos=asm.eg_vpos, bmap=asm.bmap, poses=params.poses, intr=params.intr,
        dist=params.dist, lam=asm.lam, pyr_scale=asm.pyr_scale, voxel_size=asm.voxel_size, images=asm.images,
    )


def _eg_fused_lin(asm: BlockAssembly, sh, sha, params: Params, num_chunks: int, coeff_dtype):
    """The E_g residual `[K, kb, B³]` and its coefficient fields in
    `coeff_dtype`, one E_g kernel launch a frame chunk writing straight into
    them (the card's path of `linearize_block*`)."""
    k, kb, s = asm.eg_w.shape
    r0_g = asm.eg_w.new_empty(k, kb, s)
    coeffs = tuple(asm.eg_w.new_empty((c, k, kb, s), dtype=coeff_dtype) for c in eg_rows.FIELDS)
    x = _eg_inputs(asm, sh, sha, params)
    for lo, n in _frame_chunks(k, num_chunks):
        eg_rows.eg_rows_lin(x, asm.eg_w[lo : lo + n], lo, r0_g, coeffs)
        EG_PASSES["fused"] += 1
    return r0_g, coeffs


def _eg_fused_cost(asm: BlockAssembly, sh, sha, params: Params, num_chunks: int) -> torch.Tensor:
    """Σ r² of the weighted E_g residuals: one E_g kernel launch a frame
    chunk, each writing its per-block partial sums into one buffer, then one
    sum (the card's path of `block_total_cost`)."""
    k, kb, s = asm.eg_w.shape
    chunks = _frame_chunks(k, num_chunks)
    sizes = [eg_rows.partial_blocks(n * kb * s) for _, n in chunks]
    partial = asm.eg_w.new_empty(sum(sizes))
    x = _eg_inputs(asm, sh, sha, params)
    at = 0
    for (lo, n), size in zip(chunks, sizes):
        eg_rows.eg_rows_value(x, asm.eg_w[lo : lo + n], lo, partial[at : at + size])
        EG_PASSES["fused"] += 1
        at += size
    return torch.sum(partial)


def linearize_block(params: Params, asm: BlockAssembly) -> Tuple[torch.Tensor, BlockLin]:
    """One reverse pass over all E_g elements + closed forms for the linear
    terms. Returns (cost0, lin). On the card the E_g pass is one E_g kernel
    launch (float32 coefficients)."""
    sh = asm.sdf_plan.apply(params.sdf)  # [13, nb, B³]
    sha = asm.alb_plan.apply(params.albedo)  # [7, nb, B³]
    if asm.eg_w.is_cuda:
        r0_g, coeffs = _eg_fused_lin(asm, sh, sha, params, 1, torch.float32)
    else:
        fids = torch.arange(asm.eg_w.shape[0], dtype=torch.int32, device=asm.eg_w.device)
        r0_g, coeffs = _eg_reverse(asm, sh, sha, asm.eg_w, asm.bmap, fids, params)
    return _finish_lin(sh, sha, asm, r0_g, coeffs)


def _chunk_xs(asm: BlockAssembly, num_chunks: int) -> list:
    """Split the element grid's frame axis into chunks of kc = ⌈K/C⌉ frames:
    `[(first frame, frames held, inputs)]`. The last chunk is padded to kc
    frames with weight-0 rows whose frame id is clipped to K−1 and whose
    bucket rows index the pad block, so every chunk has one shape (a chunk
    that would hold padding only is left out: it adds nothing)."""
    k, kb, s = asm.eg_w.shape
    kc = -(-k // num_chunks)
    nb = asm.er_w.shape[0]
    out = []
    for lo, n in _frame_chunks(k, num_chunks):
        x = dict(
            eg_w=asm.eg_w[lo : lo + n],
            fids=torch.clamp(torch.arange(lo, lo + kc, dtype=torch.int32, device=asm.eg_w.device), max=k - 1),
            bmap=None if asm.bmap is None else asm.bmap[lo : lo + n],
        )
        if n < kc:
            x["eg_w"] = torch.cat([x["eg_w"], x["eg_w"].new_zeros(kc - n, kb, s)])
            if x["bmap"] is not None:
                x["bmap"] = torch.cat([x["bmap"], torch.full_like(x["bmap"][:1], nb).expand(kc - n, -1)])
        out.append((lo, n, x))
    return out


def linearize_block_chunked(
    params: Params, asm: BlockAssembly, num_chunks: int, coeff_dtype=torch.float32
) -> Tuple[torch.Tensor, BlockLin]:
    """`linearize_block` with the E_g reverse pass STREAMED over frame chunks
    (`_chunk_xs`), one chunk at a time, each chunk's graph freed before the
    next: the transients are bounded at ⌈K/C⌉ frames' worth while the full
    element grid keeps the exact per-voxel top-N over all frames
    (``colorization.cpp:357-370``). Only the 29 coefficient fields, written
    in `coeff_dtype` straight into preallocated `[F, K, kb, B³]` outputs,
    and the float32 residual persist. With float32 the result is
    `linearize_block`'s: chunking re-batches the same per-element math. On
    the card each chunk is one E_g kernel launch writing the fields in
    `coeff_dtype` (one chunk too: the same numbers as `linearize_block`'s
    cast)."""
    if asm.eg_w.is_cuda:
        sh = asm.sdf_plan.apply(params.sdf)
        sha = asm.alb_plan.apply(params.albedo)
        r0_g, coeffs = _eg_fused_lin(asm, sh, sha, params, num_chunks, coeff_dtype)
        return _finish_lin(sh, sha, asm, r0_g, coeffs)
    if num_chunks <= 1:
        cost0, lin = linearize_block(params, asm)
        return cost0, lin if coeff_dtype == torch.float32 else cast_lin(lin, coeff_dtype)
    k, kb, s = asm.eg_w.shape
    sh = asm.sdf_plan.apply(params.sdf)
    sha = asm.alb_plan.apply(params.albedo)
    r0_g = asm.eg_w.new_empty(k, kb, s)
    coeffs = tuple(asm.eg_w.new_empty((c, k, kb, s), dtype=coeff_dtype) for c in (10, 4, 6, 4, 5))
    for lo, n, x in _chunk_xs(asm, num_chunks):
        r0_c, grads = _eg_reverse(asm, sh, sha, x["eg_w"], x["bmap"], x["fids"], params)
        r0_g[lo : lo + n] = r0_c[:n]
        for out, g in zip(coeffs, grads):
            out[:, lo : lo + n] = g[:, :n]
        del r0_c, grads
    return _finish_lin(sh, sha, asm, r0_g, coeffs)


def block_total_cost(params: Params, asm: BlockAssembly, num_chunks: int = 1, masked: bool = True) -> torch.Tensor:
    """Total cost `0.5·‖r‖²` with the E_g forward streamed over frame chunks
    (the LM acceptance of the streamed solve: the whole residual stack would
    hold element-grid-sized temporaries). One chunk is
    `block_all_residuals`' sum. On the card (`masked`) the E_g part is one
    E_g kernel launch a chunk, each writing its r² partial sums into one
    buffer, and one sum."""
    if asm.eg_w.is_cuda and masked:
        sh = asm.sdf_plan.apply(params.sdf)
        sha = asm.alb_plan.apply(params.albedo)
        return _with_linear_terms(sh, sha, asm, _eg_fused_cost(asm, sh, sha, params, num_chunks))
    if num_chunks <= 1:
        EG_PASSES["eager"] += 1
        r = block_all_residuals(params, asm, masked=masked)
        return 0.5 * torch.sum(r * r)
    sh = asm.sdf_plan.apply(params.sdf)
    sha = asm.alb_plan.apply(params.albedo)
    cost_g = sh.new_zeros(())
    for _, _, x in _chunk_xs(asm, num_chunks):
        EG_PASSES["eager"] += 1
        eg_w = x["eg_w"]
        stacks, sh9, vpos, fid = _eg_chunk_inputs(
            asm, sh, sha, eg_w, x["bmap"], x["fids"], params.poses, params.intr, params.dist
        )
        r = eg_core(
            *(a.movedim(0, -1) for a in stacks),
            sh9.movedim(0, -1),
            vpos.movedim(0, -1),
            fid,
            asm.images,
            asm.pyr_scale,
            asm.voxel_size,
            active=(eg_w > 0).to(torch.float32) if masked else None,
        )
        r = torch.sqrt(eg_w * asm.lam[0]) * r
        cost_g = cost_g + torch.sum(r * r)
    return _with_linear_terms(sh, sha, asm, cost_g)


def _with_linear_terms(sh, sha, asm: BlockAssembly, cost_g) -> torch.Tensor:
    """`0.5·‖r‖²` from the E_g part `cost_g` (Σ r²) and the closed-form
    linear terms."""
    r_r, r_s, r_a, _, _, _ = _linear_terms(sh, sha, asm)
    return 0.5 * (cost_g + torch.sum(r_r * r_r) + torch.sum(r_s * r_s) + torch.sum(r_a * r_a))


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


def _sum_frames(vals: torch.Tensor, bmap, nb: int, s: int) -> torch.Tensor:
    """`[F, K, kb, B³]` per-element values → `[F, nb, B³]` per-slot sums over
    the frames (a row sum dense, `_unbucket` bucketed)."""
    if bmap is None:
        return torch.sum(vals, dim=1)
    return _unbucket(vals, bmap, nb, s)


def jv_block(lin: BlockLin, asm: BlockAssembly, v: Params, include_globals: bool = True):
    """J·v — the tangent of the residual parts (y_g, y_r, y_s, y_a).

    Products of (possibly bf16) coefficients with float32 vectors are taken in
    float32, as JAX promotes them. `include_globals=False` skips the
    pose/intr/dist tangents (the Schur-reduced matvec's voxel-only tangent)."""
    sh = asm.sdf_plan.apply(v.sdf)
    sha = asm.alb_plan.apply(v.albedo)
    if asm.bmap is None:
        shf, shaf = sh[:10].unsqueeze(1), sha[:4].unsqueeze(1)  # [t, 1, nb, B³]
    else:
        shf, shaf = _gather_rows(sh[:10], asm.bmap), _gather_rows(sha[:4], asm.bmap)  # [t, K, NBc, B³]
    y_g = torch.sum(lin.a_sdf * shf, dim=0)
    y_g = y_g + torch.sum(lin.a_alb * shaf, dim=0)
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

    q = _sum_frames(lin.a_sdf * y_g.unsqueeze(0), asm.bmap, nb, s)  # [10, nb, B³]
    cot = [q[j] for j in range(10)] + [zeros() for _ in range(len(asm.sdf_plan.offsets) - 10)]
    yr = lin.sq_er * y_r
    _ring_into(asm.sdf_plan, cot, -6.0 * yr, yr)
    c = asm.sdf_plan.index((0, 0, 0))
    cot[c] = cot[c] + lin.sq_es * y_s
    g_sdf = asm.sdf_plan.apply_transpose(torch.stack(cot))

    qa = _sum_frames(lin.a_alb * y_g.unsqueeze(0), asm.bmap, nb, s)  # [4, nb, B³]
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

    q2 = _sum_frames(asq * asq, asm.bmap, nb, s)  # [10, nb, B³]
    cot = [q2[j] for j in range(10)] + [
        q2.new_zeros(nb, s) for _ in range(len(asm.sdf_plan.offsets) - 10)
    ]
    wl_r = lin.sq_er * lin.sq_er
    _ring_into(asm.sdf_plan, cot, 36.0 * wl_r, wl_r)
    c = asm.sdf_plan.index((0, 0, 0))
    cot[c] = cot[c] + lin.sq_es * lin.sq_es
    d_sdf = asm.sdf_plan.apply_transpose(torch.stack(cot))

    qa2 = _sum_frames(aasq * aasq, asm.bmap, nb, s)  # [4, nb, B³]
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


def to_block_problem(
    layout: BlockLayout,
    coords: np.ndarray,
    asm: Assembly,
    masks,
    params: Params,
    bucket: bool = False,
    device="cuda",
) -> Tuple[Params, BlockAssembly, object]:
    """Re-lay a flat-table problem (`refine.assembly.build_assembly`, table
    voxel `coords [N, 3]`) into the block-dense form on `device`: same
    energy, same free parameters (host numpy, as in the JAX package). Returns
    (block params, `BlockAssembly`, block masks), the voxel fields padded to
    `[nb+1, B³]`.

    The dense layout is frame-major, so each active element lands at its
    (frame, slot): a voxel observes a keyframe at most once, so no two
    collide (the JAX function's `num_obs` argument is therefore not taken).
    `bucket=True` emits the frame-bucketed layout instead, its per-frame
    block lists built exactly from the active elements (width rounded up to
    a multiple of 8, at least 8). Raises if an active element's voxel is
    outside `layout`."""
    dev = resolve_device(device)
    check_on(dev, eg_w=asm.eg_w, sdf=params.sdf, mask=masks.sdf)
    s = layout.block**3
    nb = layout.num_blocks
    d = nb * s
    coords = np.asarray(coords)

    eg_slot = layout.slots_of(asm.eg_vpos.cpu().numpy())
    eg_w_np = asm.eg_w.cpu().numpy()
    active = eg_w_np > 0.0
    if np.any(eg_slot[active] < 0):
        raise ValueError("active E_g element references a voxel outside the block layout")
    eg_slot = np.where(eg_slot >= 0, eg_slot, 0).astype(np.int64)
    o_cap = int(asm.images.shape[0])
    frames = asm.eg_frame.cpu().numpy().astype(np.int64)

    bmap = None
    if bucket:
        blk = eg_slot // s
        bks = [np.unique(blk[active & (frames == k)]) for k in range(o_cap)]
        nbc = max((len(bk) for bk in bks), default=1)
        nbc = max(8, -(-max(nbc, 1) // 8) * 8)
        bmap = np.full((o_cap, nbc), nb, np.int64)
        pos = np.full((o_cap, nb + 1), -1, np.int64)
        for k, bk in enumerate(bks):
            bmap[k, : len(bk)] = bk
            pos[k, bk] = np.arange(len(bk))
        af = frames[active]
        didx = af * (nbc * s) + pos[af, blk[active]] * s + (eg_slot[active] % s)
        eg_w = np.zeros((o_cap, nbc, s), np.float32)
    else:
        didx = frames[active] * d + eg_slot[active]
        eg_w = np.zeros((o_cap, nb, s), np.float32)
    eg_w.reshape(-1)[didx] = eg_w_np[active]

    # per-voxel element data (the same for every observation of a voxel):
    # scattered from the active elements; slots without one carry weight 0
    eg_sh = np.zeros((9, d), np.float32)
    eg_sh[:, eg_slot[active]] = asm.eg_sh.cpu().numpy()[active].T
    eg_vpos = np.zeros((3, d), np.int32)
    eg_vpos[:, layout.vox_slot] = coords.astype(np.int32).T

    def densify(table_vals):
        out = np.zeros(d, np.float32)
        out[layout.vox_slot] = table_vals.cpu().numpy()
        return out.reshape(nb, s)

    # E_a pairs → three +axis direction weight fields
    pairs = asm.ea_pairs.cpu().numpy()
    ea_wt = asm.ea_w.cpu().numpy()
    delta = coords[pairs[:, 1]] - coords[pairs[:, 0]]
    slots_i = layout.vox_slot[pairs[:, 0]]
    slots_j = layout.vox_slot[pairs[:, 1]]
    ea_w = np.zeros((3, d), np.float32)
    for dd in range(3):
        e = np.zeros(3, np.int64)
        e[dd] = 1
        fwd = np.all(delta == e, axis=-1)
        bwd = np.all(delta == -e, axis=-1)
        ea_w[dd, slots_i[fwd]] = ea_wt[fwd]
        ea_w[dd, slots_j[bwd]] = ea_wt[bwd]

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    sdf_plan, alb_plan = layout_plans(layout, dev)
    basm = BlockAssembly(
        eg_w=t(eg_w),
        eg_sh=t(eg_sh),
        eg_vpos=t(eg_vpos, torch.int32),
        sdf_plan=sdf_plan,
        alb_plan=alb_plan,
        er_w=t(densify(asm.er_w)),
        es_ref=t(densify(asm.es_ref)),
        es_w=t(densify(asm.es_w)),
        ea_w=t(ea_w.reshape(3, nb, s)),
        lam=asm.lam,
        images=asm.images,
        pyr_scale=asm.pyr_scale,
        voxel_size=asm.voxel_size,
        bmap=None if bmap is None else t(bmap, torch.int64),
    )
    bparams = params._replace(sdf=table_to_dense(layout, params.sdf), albedo=table_to_dense(layout, params.albedo))
    bmasks = type(masks)(
        sdf=table_to_dense(layout, masks.sdf),
        albedo=table_to_dense(layout, masks.albedo),
        poses=masks.poses,
        intr=masks.intr,
        dist=masks.dist,
    )
    return bparams, basm, bmasks


def params_from_block(layout: BlockLayout, bparams: Params) -> Params:
    """Block-dense parameters → table-order Params."""
    return bparams._replace(
        sdf=dense_to_table(layout, bparams.sdf),
        albedo=dense_to_table(layout, bparams.albedo),
    )


# ---------------------------------------------------------------------------
# Frame bucket construction (host numpy; the level planner's decision input)
# ---------------------------------------------------------------------------


def _depth_interval_mips(depth: np.ndarray):
    """Conservative min/max mip pyramid of a depth map (invalid = 0 pixels
    carry +inf/-inf so they never shrink the interval). Level l cell (i, j)
    bounds the valid depths of pixels [i·2^l, (i+1)·2^l) × [j·2^l, ...)."""
    _SCANNED.pixels = depth_pixels_scanned() + int(depth.size)
    valid = depth > 0.0
    dmin = np.where(valid, depth, np.inf).astype(np.float64)
    dmax = np.where(valid, depth, -np.inf).astype(np.float64)
    mips = [(dmin, dmax)]
    while max(dmin.shape) > 1:
        dmin = _pool2(dmin, np.minimum, np.inf)
        dmax = _pool2(dmax, np.maximum, -np.inf)
        mips.append((dmin, dmax))
    return mips


def _pool2(a: np.ndarray, f, fill: float) -> np.ndarray:
    """2×2 pooling of `a` by the elementwise `f` (`np.minimum`,
    `np.maximum`) over its four strided quarters, an odd last row or column
    padded with `fill`. (A reduction over reshaped 2-wide axes gives the
    same cells at several times the cost: 119 against 26 ms a 1296×968 map
    on one core of an Intel Xeon.)"""
    h, w = a.shape
    if h % 2 or w % 2:
        p = np.full((h + h % 2, w + w % 2), fill, a.dtype)
        p[:h, :w] = a
        a = p
    return f(f(a[0::2, 0::2], a[1::2, 0::2]), f(a[0::2, 1::2], a[1::2, 1::2]))


def _footprint_depth_interval(mips, u0, u1, v0, v1):
    """Per-block [Dmin, Dmax] of valid depths inside pixel rects: at the mip
    level where each rect spans ≤ 2×2 cells, the ≤ 4 cells combined —
    conservative, since cells round outward."""
    n = len(u0)
    dmin = np.full(n, np.inf)
    dmax = np.full(n, -np.inf)
    span = np.maximum(u1 - u0, v1 - v0)
    lvl = np.clip(np.ceil(np.log2(np.maximum(span, 1))).astype(int), 0, len(mips) - 1)
    for lv in np.unique(lvl):
        sel = lvl == lv
        mn, mx = mips[lv]
        h, w = mn.shape
        i0 = np.clip(v0[sel] >> lv, 0, h - 1)
        j0 = np.clip(u0[sel] >> lv, 0, w - 1)
        i1 = np.clip(i0 + 1, 0, h - 1)
        j1 = np.clip(j0 + 1, 0, w - 1)
        dmin[sel] = np.minimum(np.minimum(mn[i0, j0], mn[i0, j1]), np.minimum(mn[i1, j0], mn[i1, j1]))
        dmax[sel] = np.maximum(np.maximum(mx[i0, j0], mx[i0, j1]), np.maximum(mx[i1, j0], mx[i1, j1]))
    return dmin, dmax


def bucket_ladder_up(x: int, step: int = 8) -> int:
    """Smallest rung ≥ x of the geometric bucket-width ladder: multiples of
    `step` growing by ~1.25× (8, 16, 24, 32, 40, 56, 72, 96, 120, 152, …)."""
    r = step
    while r < x:
        r = max(r + step, -(-int(r * 1.25) // step) * step)
    return r


def bucket_ladder_down(x: int, step: int = 8) -> int:
    """Largest rung ≤ x (≥ step) — quantizes the hard-trim cap to a rung."""
    if x <= step:
        return step
    r = prev = step
    while r <= x:
        prev = r
        r = max(r + step, -(-int(r * 1.25) // step) * step)
    return prev


def build_frame_buckets(
    layout: BlockLayout,
    poses6: np.ndarray,  # [K, 6] world→cam angle-axis + t
    intr4: np.ndarray,  # [4] fx fy cx cy at the target pyramid level
    width: int,
    height: int,
    voxel_size: float,
    margin_px: float = 48.0,
    round_to: int = 8,
    depths: Optional[np.ndarray] = None,  # [K, H, W] level depth maps
    occlusion: float = 0.0,
    depth_slack: float = 0.05,
    max_frames_per_block: int = 0,
    max_blocks_per_frame: int = 0,
    protect_cover: int = 0,
    stats: Optional[dict] = None,
) -> np.ndarray:
    """Per-frame visible-block lists from block-AABB frustum projection
    (host numpy copy of the JAX function; see its docstring for the full
    argument).

    Frame k's bucket is every block whose 8 AABB corners project (pinhole)
    into the image rect inflated by `margin_px`; blocks straddling z ≈ 0 are
    always kept. With `depths`, blocks whose camera-z interval misses the
    valid-depth interval of their pixel footprint (inflated by `occlusion +
    depth_slack`) are dropped — they can hold only weight-0 elements.
    `max_frames_per_block` keeps each block's M closest frames;
    `max_blocks_per_frame` trims each frame's bucket to M blocks
    (straddling, then cover-protected, then least-redundant, then
    best-scoring blocks survive), reporting `trimmed_pairs` and
    `uncovered_blocks` in `stats`. Returns `bmap [K, NBc] int32`, its width
    on the bucket ladder, padded with `num_blocks` (the pad row)."""
    nb = layout.num_blocks
    b = layout.block
    fx, fy, cx, cy = (float(v) for v in np.asarray(intr4, np.float64))
    lo = np.asarray(layout.block_coords, np.float64) * b * voxel_size
    sel = np.array([[i & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], np.float64)  # [8, 3] ∈ {0,1}
    corners = lo[:, None, :] + sel[None, :, :] * (b * voxel_size)  # [nb, 8, 3]

    buckets = []
    scores = []  # per frame: [nb] score of observable blocks (0 = not in bucket)
    for ki, pose in enumerate(np.asarray(poses6, np.float64)):
        t_mat = pose_vec_to_matrix(pose)
        pc = corners @ np.asarray(t_mat)[:3, :3].T + np.asarray(t_mat)[:3, 3]
        z = pc[..., 2]
        front = z > 1e-4
        any_front = np.any(front, axis=1)
        straddle = any_front & np.any(~front, axis=1)
        zs = np.where(front, z, 1.0)
        u = fx * pc[..., 0] / zs + cx
        v = fy * pc[..., 1] / zs + cy
        big = 1e18
        u_min = np.min(np.where(front, u, big), axis=1)
        u_max = np.max(np.where(front, u, -big), axis=1)
        v_min = np.min(np.where(front, v, big), axis=1)
        v_max = np.max(np.where(front, v, -big), axis=1)
        in_rect = (
            (u_max >= -margin_px)
            & (u_min <= width - 1 + margin_px)
            & (v_max >= -margin_px)
            & (v_min <= height - 1 + margin_px)
        )
        keep = (any_front & in_rect) | straddle
        z_lo = np.min(np.where(front, z, big), axis=1)
        z_hi = np.max(np.where(front, z, -big), axis=1)

        if depths is not None:
            mips = _depth_interval_mips(np.asarray(depths[ki]))
            pad = 0.5 * margin_px  # pose-drift slack on the pixel side
            u0 = np.clip(np.floor(u_min - pad).astype(np.int64), 0, width - 1)
            u1 = np.clip(np.ceil(u_max + pad).astype(np.int64), 0, width - 1)
            v0 = np.clip(np.floor(v_min - pad).astype(np.int64), 0, height - 1)
            v1 = np.clip(np.ceil(v_max + pad).astype(np.int64), 0, height - 1)
            dmin, dmax = _footprint_depth_interval(mips, u0, u1, v0, v1)
            slack = occlusion + depth_slack
            observable = (dmin - slack <= z_hi) & (dmax + slack >= z_lo)
            # blocks straddling z≈0 keep their conservative free pass
            keep = (keep & observable) | straddle

        buckets.append(np.flatnonzero(keep))
        if max_frames_per_block > 0 or max_blocks_per_frame > 0:
            s = np.where(keep, 1.0 / np.maximum(0.5 * (z_lo + z_hi), 1e-3) ** 2, 0.0)
            scores.append(np.where(straddle, np.inf, s))

    if max_frames_per_block > 0 and len(buckets) > max_frames_per_block:
        m = max_frames_per_block
        sc = np.stack(scores, axis=0)  # [K, nb]
        # per block: keep the M best-scoring frames (ties -> lower frame id)
        order = np.argsort(-sc, axis=0, kind="stable")  # [K, nb]
        rank = np.empty_like(order)
        np.put_along_axis(rank, order, np.arange(len(buckets))[:, None], axis=0)
        keep_kb = (rank < m) & (sc > 0.0)
        buckets = [np.flatnonzero(keep_kb[k]) for k in range(len(buckets))]

    if max_blocks_per_frame > 0:
        sc = np.stack(scores, axis=0)  # [K, nb]
        m = max_blocks_per_frame
        cover = np.zeros(nb, np.int64)
        for bk in buckets:
            cover[bk] += 1
        dropped = 0
        excess = [max(0, len(bk) - m) for bk in buckets]
        for k in np.argsort(-np.asarray(excess), kind="stable"):
            bk = buckets[k]
            if len(bk) <= m:
                continue
            s_k = sc[k, bk]
            # keep priority (first m survive): straddle (∞ score) > blocks at
            # or below the protected cover > least-redundantly-covered >
            # higher view score. np.lexsort: the LAST key is primary.
            straddle_k = np.isinf(s_k)
            protected = (cover[bk] <= protect_cover) & ~straddle_k
            keep_rank = np.lexsort((-s_k, cover[bk], (~protected).astype(np.int8), (~straddle_k).astype(np.int8)))
            keep = bk[keep_rank[:m]]
            drop = bk[keep_rank[m:]]
            cover[drop] -= 1
            dropped += len(drop)
            buckets[k] = np.sort(keep)
        uncovered = int(nb - np.count_nonzero(cover))
        if stats is not None:
            stats["trimmed_pairs"] = dropped
            stats["uncovered_blocks"] = uncovered
        if dropped:
            log.warning(
                "  frame buckets: memory budget trimmed %d (block, frame) pairs to %d blocks/frame "
                "(cover-protected at %d frames/block); %d/%d blocks lost all frames",
                dropped, m, protect_cover, uncovered, nb,
            )

    nbc = max((len(bk) for bk in buckets), default=1)
    # the bucket width on the geometric ladder, capped at the dense width nb
    # (rounded to round_to); padding entries index the pad block
    cap = max(round_to, -(-nb // round_to) * round_to)
    nbc = min(bucket_ladder_up(max(nbc, 1), round_to), cap)
    bmap = np.full((len(buckets), nbc), nb, np.int32)
    for k, bk in enumerate(buckets):
        bmap[k, : min(len(bk), nbc)] = bk[:nbc]
    return bmap
