"""Spatial block sharding of the production solver, one process per rank.

Counterpart of `intrinsic3d_tpu/parallel/spmd.py`, whose `shard_map` bodies
become code each rank runs on its own brick with explicit collectives:

- each rank owns a contiguous BRICK of `m = nb / n` block rows: parameters,
  masks, per-slot weights and the frame-major E_g element fields all split
  along the block axis, so a rank's parameter memory is `nb/n` rows plus a
  halo surface;
- stencil shifts cross brick boundaries through the static halo plan
  (`parallel.halo.HaloPlan`): `ShardedPlan` ships exactly the needed boundary
  rows in one all-to-all per exchange, and the transposed scatter-add rides
  the same tables backwards. It is duck-typed for the port's gather-based
  `grid.blocks.ShiftPlan` (`apply`, `apply_transpose`, `index`, `offsets`),
  so every `refine.blockform` routine runs unchanged on a brick;
- the samplers run per rank on the rank's element columns with the images
  replicated;
- the global parameters (poses, intrinsics, distortion) are replicated;
  their gradient, Gauss-Newton products and every cost and PCG scalar are
  all-reduced (`refine.solver.gn_iteration(mesh=...)`);
- frame-bucketed elements are partitioned by block owner
  (`localize_buckets`), so per-slot fetches, the per-voxel top-N and the
  `_unbucket` scatter-adds stay on the rank.

`SpmdLevel` is the production path: `refine.optimizer.optimize_level(mesh=)`
runs each outer iteration's device assembly and damped-GN solve on the
rank's brick. Not ported: `SpmdLevel.warm` and its compiled-executable
fallback (the TPU's program-upload workaround, as `LevelPrep` is).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from intrinsic3d_torch.grid.blocks import BlockLayout, ShiftPlan, pad_flat
from intrinsic3d_torch.parallel.halo import HaloPlan, build_halo_plan
from intrinsic3d_torch.parallel.sharding import Mesh
from intrinsic3d_torch.parallel.staging import row_range, to_global
from intrinsic3d_torch.refine.blockform import BlockAssembly, layout_plans
from intrinsic3d_torch.refine.residuals import Params


@dataclasses.dataclass
class ShardedPlan:
    """One rank's stencil-shift plan with halo exchange.

    Fields are the rank's `[m+1, B³]` block rows (trailing pad row); outputs
    `[T, m, B³]`. The extended field is `[local m rows | received rows in
    source-rank order | pad row]`; `nbr` indexes it."""

    offsets: np.ndarray  # [T, 3]
    dir_vecs: np.ndarray  # [D, 3]
    nbr: torch.Tensor  # [D, m] int64 extended-field row per direction
    lane_src: torch.Tensor  # [T, B³] int64 source lane in the [D·B³] row stack
    block: int
    mesh: Mesh
    send_rows: torch.Tensor  # [Σ in_splits] int64 local rows shipped, in destination-rank order
    in_splits: Tuple[int, ...]  # rows shipped to each rank
    out_splits: Tuple[int, ...]  # rows received from each rank

    @property
    def m(self) -> int:
        return int(self.nbr.shape[1])

    @property
    def recv_rows(self) -> int:
        return int(sum(self.out_splits))

    def _exchange(self, field_pad: torch.Tensor) -> torch.Tensor:
        """`[m+1, B³]` local rows → the extended field `[m + Σhs + 1, B³]`:
        every active mesh shift's rows in one all-to-all."""
        m = self.m
        if self.recv_rows == 0:
            return field_pad
        recv = self.mesh.all_to_all(field_pad[self.send_rows], self.in_splits, self.out_splits)
        return torch.cat([field_pad[:m], recv, field_pad[m:]])

    def _exchange_transpose(self, acc_ext: torch.Tensor) -> torch.Tensor:
        """Adjoint of `_exchange`: extended-row cotangents → `[m+1, B³]`."""
        m = self.m
        if self.recv_rows == 0:
            return acc_ext
        out = torch.cat([acc_ext[:m], acc_ext[-1:]])
        back = self.mesh.all_to_all(acc_ext[m : m + self.recv_rows], self.out_splits, self.in_splits)
        return out.index_add_(0, self.send_rows, back)

    def apply(self, field_pad: torch.Tensor) -> torch.Tensor:
        s = self.block**3
        m = self.m
        ext = self._exchange(field_pad)
        stack = ext[self.nbr.T].reshape(m, -1)  # [m, D·B³] block-row gather
        out = stack[:, self.lane_src.reshape(-1)]
        return out.reshape(m, len(self.offsets), s).transpose(0, 1)

    def apply_transpose(self, cot: torch.Tensor) -> torch.Tensor:
        t, m, s = cot.shape
        stack = cot.new_zeros(m, len(self.dir_vecs) * s)
        for i in range(t):
            stack.index_add_(1, self.lane_src[i], cot[i])
        rows = stack.view(m, len(self.dir_vecs), s)
        acc = cot.new_zeros(m + self.recv_rows + 1, s)
        for d in range(len(self.dir_vecs)):
            acc.index_add_(0, self.nbr[d], rows[:, d])
        return self._exchange_transpose(acc)

    def index(self, offset) -> int:
        o = np.asarray(offset)
        hit = np.flatnonzero(np.all(self.offsets == o, axis=-1))
        if len(hit) != 1:
            raise KeyError(f"offset {tuple(o)} not in plan")
        return int(hit[0])


def _rank_tables(hp: HaloPlan, rank: int):
    """This rank's all-to-all layout of the halo plan: (send rows in
    destination-rank order, rows to each rank, rows from each rank, the map
    from the plan's shift-ordered pool rows to the received rows' source-rank
    order)."""
    n, m = hp.n, hp.m
    send, in_splits, out_splits = [], [0] * n, [0] * n
    recv_base, off = {}, 0
    for src in range(n):  # received rows, in source-rank order
        d = (rank - src) % n
        if d in hp.shifts:
            h = hp.hs[hp.shifts.index(d)]
            out_splits[src] = h
            recv_base[d] = off
            off += h
    for dst in range(n):
        d = (dst - rank) % n
        if d in hp.shifts:
            i = hp.shifts.index(d)
            send.append(hp.send[i][rank])
            in_splits[dst] = hp.hs[i]
    pool_map = np.arange(hp.ext_rows, dtype=np.int64)
    pool = m
    for d, h in zip(hp.shifts, hp.hs):
        pool_map[pool : pool + h] = m + recv_base[d] + np.arange(h)
        pool += h
    send_rows = np.concatenate(send).astype(np.int64) if send else np.zeros(0, np.int64)
    return send_rows, tuple(in_splits), tuple(out_splits), pool_map


def make_sharded_plans(layout: BlockLayout, plans: Tuple[ShiftPlan, ...], mesh: Mesh) -> Tuple[HaloPlan, Tuple[ShardedPlan, ...]]:
    """The halo exchange of `plans` over the mesh and this rank's
    `ShardedPlan`s."""
    hp = build_halo_plan(layout.num_blocks, mesh.size, [p.nbr.cpu().numpy() for p in plans])
    send_rows, in_splits, out_splits, pool_map = _rank_tables(hp, mesh.rank)
    dev = mesh.device
    out = []
    for p, nbr_local in zip(plans, hp.nbr_local):
        out.append(
            ShardedPlan(
                offsets=p.offsets,
                dir_vecs=p.dir_vecs,
                nbr=torch.as_tensor(pool_map[nbr_local[mesh.rank]], device=dev),
                lane_src=p.lane_src.to(dev),
                block=p.block,
                mesh=mesh,
                send_rows=torch.as_tensor(send_rows, device=dev),
                in_splits=in_splits,
                out_splits=out_splits,
            )
        )
    return hp, tuple(out)


# ---------------------------------------------------------------------------
# Frame-bucket localization (bucketed layout under spatial sharding)
# ---------------------------------------------------------------------------


def localize_buckets(num_blocks: int, bmap: np.ndarray, n: int, round_to: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Partition global frame buckets by block OWNER.

    Rank p owns the block rows `[p·m, (p+1)·m)`; its bucket for frame k is
    the global bucket's blocks inside that brick, remapped to local rows.
    Every per-slot quantity of a bucketed element is keyed by its block row,
    so owner partitioning keeps the whole bucketed data path on the rank.

    Returns:
      - ``bmap_dev [n, K, NBc_l] int32`` — per-rank local block rows
        (padding = m, the rank's all-zero pad row);
      - ``colsel [n, K, NBc_l] int64`` — the GLOBAL bucket column each local
        entry came from (padding = NBc, a zero pad column), the gather table
        for re-sharding prebuilt `[K, NBc, B³]` element fields.
    """
    nb = num_blocks
    if nb % n != 0:
        raise ValueError(f"num_blocks {nb} not divisible by mesh size {n}")
    m = nb // n
    k, nbc = bmap.shape
    owner = np.where(bmap < nb, bmap // m, -1)  # [K, NBc]
    counts = np.zeros((n, k), np.int64)
    for p in range(n):
        counts[p] = np.sum(owner == p, axis=1)
    nbc_l = max(int(counts.max()), 1)
    nbc_l = -(-nbc_l // round_to) * round_to
    bmap_dev = np.full((n, k, nbc_l), m, np.int32)
    colsel = np.full((n, k, nbc_l), nbc, np.int64)
    for p in range(n):
        for kk in range(k):
            cols = np.flatnonzero(owner[kk] == p)
            bmap_dev[p, kk, : len(cols)] = bmap[kk, cols] - p * m
            colsel[p, kk, : len(cols)] = cols
    return bmap_dev, colsel


# ---------------------------------------------------------------------------
# Per-level context: the halo plans, built once per level
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SpmdContext:
    """This rank's sharded stencil plans for one (BlockLayout, mesh) pair,
    built once per level (`make_spmd_context`) and reused by every step."""

    mesh: Mesh
    layout: BlockLayout
    halo: HaloPlan
    sdf_plan_s: ShardedPlan
    alb_plan_s: ShardedPlan

    @property
    def m(self) -> int:
        return self.halo.m

    def brick(self) -> Tuple[int, int]:
        """This rank's block rows `[lo, hi)`."""
        return row_range(self.mesh, self.layout.num_blocks)


def make_spmd_context(layout: BlockLayout, mesh: Mesh) -> SpmdContext:
    plans = layout_plans(layout, "cpu")  # host tables for the halo plan
    hp, (sdf_s, alb_s) = make_sharded_plans(layout, plans, mesh)
    return SpmdContext(mesh=mesh, layout=layout, halo=hp, sdf_plan_s=sdf_s, alb_plan_s=alb_s)


def _brick_rows(x: torch.Tensor, lo: int, hi: int, dim: int, dev) -> torch.Tensor:
    return x.narrow(dim, lo, hi - lo).to(dev)


# ---------------------------------------------------------------------------
# The SPMD GN iteration (prebuilt-assembly form: tests / dryrun)
# ---------------------------------------------------------------------------


def place_spmd_problem(bparams: Params, basm: BlockAssembly, bmasks, ctx: SpmdContext):
    """This rank's brick of a global block problem, on the rank's device:
    voxel-shaped fields sliced to the brick (with a pad row), per-slot
    `[C, nb·B³]` fields to the brick's columns, dense element fields along
    their block axis, frame-bucketed element fields re-sharded by owner
    (`localize_buckets`); globals, λ and images replicated. Returns
    `(params, assembly, masks)` in the rank's local form."""
    from intrinsic3d_torch.refine.solver import Masks

    mesh = ctx.mesh
    dev = mesh.device
    nb = ctx.layout.num_blocks
    s = ctx.layout.block**3
    lo, hi = ctx.brick()

    def vox(x):  # [nb+1, S] → [m+1, S]
        return pad_flat(_brick_rows(x, lo, hi, 0, dev))

    def cols(x):  # [C, nb·S] → [C, m·S]
        return _brick_rows(x.reshape(x.shape[0], nb, s), lo, hi, 1, dev).reshape(x.shape[0], -1)

    def rep(x):
        return x.to(dev)

    if basm.bmap is None:
        eg_w, bmap = _brick_rows(basm.eg_w, lo, hi, 1, dev), None
    else:
        bmap_dev, colsel = localize_buckets(nb, basm.bmap.cpu().numpy(), mesh.size)
        eg_w_pad = torch.cat([basm.eg_w, basm.eg_w.new_zeros(basm.eg_w.shape[0], 1, s)], dim=1)
        sel = torch.as_tensor(colsel[mesh.rank], device=eg_w_pad.device)
        eg_w = torch.take_along_dim(eg_w_pad, sel[:, :, None], dim=1).to(dev)
        bmap = torch.as_tensor(bmap_dev[mesh.rank], dtype=torch.int64, device=dev)
    basm_l = BlockAssembly(
        eg_w=eg_w,
        eg_sh=cols(basm.eg_sh),
        eg_vpos=cols(basm.eg_vpos),
        sdf_plan=ctx.sdf_plan_s,
        alb_plan=ctx.alb_plan_s,
        er_w=_brick_rows(basm.er_w, lo, hi, 0, dev),
        es_ref=_brick_rows(basm.es_ref, lo, hi, 0, dev),
        es_w=_brick_rows(basm.es_w, lo, hi, 0, dev),
        ea_w=_brick_rows(basm.ea_w, lo, hi, 1, dev),
        lam=rep(basm.lam),
        images=rep(basm.images),
        pyr_scale=rep(basm.pyr_scale),
        voxel_size=rep(basm.voxel_size),
        bmap=bmap,
    )
    bp = Params(vox(bparams.sdf), vox(bparams.albedo), rep(bparams.poses), rep(bparams.intr), rep(bparams.dist))
    bm = Masks(vox(bmasks.sdf), vox(bmasks.albedo), rep(bmasks.poses), rep(bmasks.intr), rep(bmasks.dist))
    return bp, basm_l, bm


def gather_params(ctx: SpmdContext, bp_local: Params) -> Params:
    """The rank-local block params `[m+1, S]` → the global `[nb+1, S]`
    block form on every rank (one all-gather per voxel field)."""
    return bp_local._replace(
        sdf=pad_flat(to_global(ctx.mesh, bp_local.sdf[:-1])),
        albedo=pad_flat(to_global(ctx.mesh, bp_local.albedo[:-1])),
    )


def spmd_gn_iteration(
    bparams: Params,
    basm: BlockAssembly,
    bmasks,
    mu,
    layout: BlockLayout,
    mesh: Mesh,
    lm_steps: int = 50,
    cg_iters: int = 12,
    cg_coeff_dtype: str = "bfloat16",
    ctx: Optional[SpmdContext] = None,
    schur_globals: bool = False,
):
    """One relinearize→solve→accept cycle under spatial block sharding.

    The same energy and step as `solver.gn_iteration` on the same global
    block problem (the halo'd stencils reproduce the global shifts exactly;
    global reductions are all-reduced), dense or frame-bucketed. Every rank
    passes the same global problem; each places its brick
    (`place_spmd_problem`). Returns `gn_iteration`'s outputs with the params
    gathered back to the global block form on every rank. Pass `ctx`
    (`make_spmd_context`) to reuse the halo plans across calls."""
    from intrinsic3d_torch.refine.solver import gn_iteration

    ctx = ctx or make_spmd_context(layout, mesh)
    bp, basm_l, bm = place_spmd_problem(bparams, basm, bmasks, ctx)
    out_p, c0, c1, mu2, tries = gn_iteration(
        bp, basm_l, bm, mu, lm_steps=lm_steps, cg_iters=cg_iters, cg_coeff_dtype=cg_coeff_dtype,
        schur_globals=schur_globals, device=mesh.device, mesh=mesh,
    )
    return gather_params(ctx, out_p), c0, c1, mu2, tries


# ---------------------------------------------------------------------------
# SpmdLevel: the production pipeline path (device assembly + solve on the
# rank's brick, statics placed once per level)
# ---------------------------------------------------------------------------


class SpmdLevel:
    """Per-(grid, pyramid)-level multi-device execution of the production
    outer loop (`refine.optimizer.optimize_level(mesh=...)`).

    Construction (once per level) builds the halo plans and places this
    rank's level statics — occupancy and validity, the fused-SDF anchor, the
    per-voxel SH, the chromaticity pair weights — as brick rows, the depth
    and intensity images replicated, and this rank's owner-localized frame
    buckets. Each `step` then runs the whole outer iteration on the brick:
    `device_assembly` (observation re-collection with the current
    parameters, gates, validity probe, all-reduced weight normalization)
    followed by `gn_iteration` (damped GN/PCG with halo'd stencils and
    all-reduced globals). The outer loop feeds back the rank's parameters
    and the two scalars (μ, the scheduled λ)."""

    def __init__(
        self,
        mesh: Mesh,
        layout: BlockLayout,
        st,  # refine.device_assembly.LevelStatic, global (any device)
        depths: torch.Tensor,  # [K, H, W]
        images: torch.Tensor,  # [K, H, W]
        *,
        num_obs: int,
        width: int,
        height: int,
        pyr_scale: float,
        voxel_size: float,
        truncation: float,
        thres_shell: float,
        occlusion_distance: float,
        fix_poses: bool,
        fix_intrinsics: bool,
        fix_distortion: bool,
        use_albedo: bool,
        bmap: Optional[np.ndarray] = None,  # [K, NBc] global frame buckets
        lm_steps: int = 50,
        cg_iters: int = 12,
        cg_coeff_dtype: str = "bfloat16",
        cg_eta: float = 0.1,
        ctx: Optional[SpmdContext] = None,
        eg_sh_device: Optional[torch.Tensor] = None,
        schur_globals: bool = False,
        min_pose_obs: int = 0,
        eg_chunks: int = 1,
    ):
        """`eg_sh_device` replaces `st.eg_sh` with the rank's `[9, m, B³]`
        per-voxel SH (the output of `SpmdStages.svsh`), so the full-grid
        voxel-SH field never exists on one rank. `eg_chunks > 1` streams the
        rank's E_g linearization over frame chunks."""
        from intrinsic3d_torch.refine.device_assembly import LevelStatic

        self.ctx = ctx or make_spmd_context(layout, mesh)
        self.mesh = mesh
        self.layout = layout
        dev = mesh.device
        nb = layout.num_blocks
        s = layout.block**3
        lo, hi = self.ctx.brick()

        def rows(x, dim=0):
            return _brick_rows(x, lo, hi, dim, dev)

        self._stat = LevelStatic(
            occ=pad_flat(rows(st.occ[:-1])),
            valid=pad_flat(rows(st.valid[:-1])),
            vpos=rows(st.vpos.reshape(3, nb, s), 1).reshape(3, -1),
            es_ref=rows(st.es_ref),
            eg_sh=(eg_sh_device if eg_sh_device is not None else rows(st.eg_sh.reshape(9, nb, s), 1)).reshape(9, -1),
            ea_chroma=rows(st.ea_chroma, 1),
        )
        self._depths = depths.to(dev)
        self._images = images.to(dev)
        self._scalars = (pyr_scale, voxel_size, truncation, thres_shell, occlusion_distance)
        self._bmap = None
        if bmap is not None:
            bmap_dev, _ = localize_buckets(nb, np.asarray(bmap), mesh.size)
            self._bmap = torch.as_tensor(bmap_dev[mesh.rank], dtype=torch.int64, device=dev)
        self._assembly_kw = dict(
            num_obs=num_obs, width=width, height=height, fix_poses=fix_poses, fix_intrinsics=fix_intrinsics,
            fix_distortion=fix_distortion, use_albedo=use_albedo, min_pose_obs=min_pose_obs,
        )
        self._solver_kw = dict(
            lm_steps=lm_steps, cg_iters=cg_iters, cg_coeff_dtype=cg_coeff_dtype, cg_eta=cg_eta,
            schur_globals=schur_globals, eg_chunks=eg_chunks,
        )

    # -- outer-loop API ----------------------------------------------------

    def begin(self, bparams: Params) -> Params:
        """The rank's brick of the global block params (`[m+1, B³]` voxel
        fields with a pad row), globals replicated, on the rank's device."""
        lo, hi = self.ctx.brick()
        dev = self.mesh.device
        return Params(
            sdf=pad_flat(_brick_rows(bparams.sdf, lo, hi, 0, dev)),
            albedo=pad_flat(_brick_rows(bparams.albedo, lo, hi, 0, dev)),
            poses=bparams.poses.to(dev),
            intr=bparams.intr.to(dev),
            dist=bparams.dist.to(dev),
        )

    def placement(self) -> list:
        """(name, global bytes, this rank's bytes) of each per-voxel static
        the level placed as the rank's `m` brick rows (pad rows excluded),
        and of the owner-localized frame buckets (one `[K, NBc_l]` table a
        rank): the evidence that the level holds about 1/n a rank."""
        st, m, nb = self._stat, self.ctx.m, self.layout.num_blocks
        out = [
            (name, a.element_size() * a.numel() * nb // m, a.element_size() * a.numel())
            for name, a in (("st.occ", st.occ[:-1]), ("st.valid", st.valid[:-1]), ("st.es_ref", st.es_ref),
                            ("st.ea_chroma", st.ea_chroma), ("st.eg_sh", st.eg_sh))
        ]
        if self._bmap is not None:
            mine = self._bmap.element_size() * self._bmap.numel()
            out.append(("bmap", mine * self.mesh.size, mine))
        return out

    def step(self, bparams_s: Params, lambdas, mu):
        """One outer iteration on the rank's brick (its assembly in a
        `solve.assemble` span, as `optimizer.fused_outer_step`'s). Returns
        (params', cost0, cost1, mu', tries), params' in the rank's form —
        feed it back in."""
        from intrinsic3d_torch.refine.device_assembly import device_assembly
        from intrinsic3d_torch.refine.solver import gn_iteration
        from intrinsic3d_torch.timer import span

        dev = self.mesh.device
        with span("solve.assemble"):
            basm, bmasks = device_assembly(
                self._stat, self.ctx.sdf_plan_s, self.ctx.alb_plan_s, bparams_s, self._depths, self._images,
                *self._scalars, lambdas, **self._assembly_kw, bmap=self._bmap, device=dev, mesh=self.mesh,
            )
        return gn_iteration(bparams_s, basm, bmasks, mu, **self._solver_kw, device=dev, mesh=self.mesh)

    def finish(self, bparams_s: Params) -> Params:
        """The global `[nb+1, B³]` block params on every rank."""
        return gather_params(self.ctx, bparams_s)

