"""Per-level optimization driver: the reference's ``Optimizer::optimize``
loop (``optimizer.cpp:109-173``).

Counterpart of `intrinsic3d_tpu/refine/optimizer.py` on one device:
`optimize_level` runs a (grid, pyramid) level's outer iterations, each
re-collecting observations with the current parameters, rebuilding the
assembly with the scheduled λ_r/λ_s and taking one accepted damped
Gauss-Newton step (`fused_outer_step`); `plan_eg_layout` chooses the level's
E_g element layout (dense, frame-bucketed, streamed over frame chunks, or
frame-capped) by the JAX package's rules with the card's own memory
constants, and a level whose first step runs out of device memory is
replanned once at 60% of the budget. `prepare_level` builds one level's
layout, statics and shift plans for a caller that steps it itself.
`optimize_level(use_blocks=False)` runs the flat-table oracle instead
(`refine.assembly.build_assembly` + the flat `gn_iteration`). The level's
setup and solve are `timer.span` phases under the JAX package's names
(`level_setup[p*v*]`, `solve[p*v*]`), each outer step's assembly a
`solve.assemble` span inside the solve, and the solve's device-to-host
reads are counted in `timer.HOST_READS` (`OptimizeStats.host_reads`).
`optimize_level(mesh=)` runs the same outer loop on one rank's brick of a
spatially sharded level (`parallel.spmd.SpmdLevel`). `LevelPrep` builds a
level's host half on a background thread while the caller estimates the
lighting (layout and plan; where the level builds its statics on the host,
the stencil tables and the statics with zero SH too), and
`optimize_level(prep=)` takes it over; the JAX package's program warm-up in
the same class has no counterpart (the card has no program to load).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from intrinsic3d_torch.camera import Camera
from intrinsic3d_torch.config import RefinementConfig
from intrinsic3d_torch.device import resolve_device
from intrinsic3d_torch.grid.blocks import BlockLayout, ShiftPlan
from intrinsic3d_torch.grid.voxel_grid import VoxelGrid
from intrinsic3d_torch.mathutil import compute_varying_lambda, pyramid_level_to_scale
from intrinsic3d_torch.refine.assembly import LevelTopology, build_assembly, level_topology
from intrinsic3d_torch.refine.blockform import (
    EG_PASSES,
    bucket_ladder_down,
    build_frame_buckets,
    depth_pixels_scanned,
    layout_plans,
    params_from_block,
    table_to_dense,
)
from intrinsic3d_torch.prefetch import HostPrep
from intrinsic3d_torch.refine.device_assembly import (
    LevelStatic,
    build_level_static,
    device_assembly,
    fill_voxel_sh,
    level_static_host,
    statics_on_card,
    upload_level_static,
)
from intrinsic3d_torch.refine.residuals import Params
from intrinsic3d_torch.refine.solver import gn_iteration
from intrinsic3d_torch.timer import HOST_READS, host_reads, record_phase, span

log = logging.getLogger("intrinsic3d")

# The card's peak bytes per E_g element, whole-step peaks of
# `torch.cuda.max_memory_allocated` over the layout's elements (images,
# statics and solver temporaries included) on an NVIDIA H100 80GB HBM3 at
# 700 W. Dense: the finest bench_pipeline level's peak, 36.42 GB over 10 ×
# 5,728 × 512 elements (chip_smoke.py's refinement phase), and the bench.py
# step's, 3.337 GB over 2,686,976 elements (tools/profile_torch_eg_memory.py);
# smaller levels read more (a larger fixed share), but only large levels near
# the budget turn on it.
_EG_DENSE_BYTES_PER_ELEMENT = 1242
# Bucketed one-shot: 2.589 GB over the bench step's 1,966,080 exact-bucket
# elements, 1,316.6 B (tools/profile_torch_eg_memory.py; the block-row
# gathers add to the dense figure). As in the JAX package it sizes only the
# hard per-frame trim (through min(dense, bucket)); the one-shot fit of the
# exact buckets is judged at the dense figure, 6% under this one, a gap the
# budget's 30% headroom and the out-of-memory replan cover.
_EG_BUCKET_BYTES_PER_ELEMENT = 1320
# Streamed layout (linearize_block_chunked) memory model, the JAX package's:
#     peak ≈ max(el·ASSEMBLY, el·PERSIST + ⌈K/C⌉·el_frame·TRANSIENT)
# from tools/profile_torch_eg_memory.py's bucketed steps in C frame chunks:
# bench step (K = 8) 1,316.6 / 764.3 / 439.3 / 415.1 B per element at C = 1 /
# 2 / 4 / 8; the 90-frame orbit's finest level (K = 30, 69.8 M elements) out
# of memory / 714.8 / 417.4 / 339.7 B at C = 1 / 2 / 4 / 8. PERSIST and
# TRANSIENT are the line through the bench step's C = 1 and C = 2 readings
# (212.0 + 1,104.6 B), rounded up; it lies above every other reading but the
# bench step's C = 8, which the assembly's own peak sets, so with ASSEMBLY it
# bounds the streamed peak from above. PERSIST + TRANSIENT ≥ the dense figure, so a plan that
# rejects the exact buckets one-shot streams in ≥ 2 chunks, or trims only
# when one-frame chunks cannot fit (tests/test_torch_buckets.py).
_EG_CHUNK_PERSIST_BYTES = 220
_EG_CHUNK_TRANSIENT_BYTES = 1110
# the assembly phase (observation weights, the top-N rank over all K frames,
# the validity probe), which chunking cannot shrink: 398.1 B per element at
# the bench step, 339.7 B at the orbit's finest level (bucketed assembly
# alone, same tool)
_EG_ASSEMBLY_BYTES = 400
# memory kept out of the element budget for everything that is not an E_g
# element temporary (images, persistent fields, non-element solver temps)
_EG_HBM_HEADROOM = 4.75e9


def eg_hbm_budget(device="cuda") -> float:
    """Memory budget of the dense E_g element fields:
    min(total − 4.75 GB, 0.7·total) of the device's memory — the card's from
    `torch.cuda.mem_get_info` (a failed query raises), the host's physical
    memory for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        total = float(torch.cuda.mem_get_info(dev)[1])
    else:
        total = float(os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))
    return min(total - _EG_HBM_HEADROOM, 0.7 * total)


def level_budget(device="cuda", mesh=None) -> float:
    """The E_g element budget a level plans against by default: one card's
    (`eg_hbm_budget`), or under `mesh` one card's times the ranks over the
    ranks sharing a card (the element fields split about 1/n a rank)."""
    dev = mesh.device if mesh is not None else device
    return eg_hbm_budget(dev) * (1.0 if mesh is None else mesh.size / mesh.ranks_on_device)


def plan_eg_layout(
    layout: BlockLayout,
    poses: np.ndarray,  # [K, 6]
    intr_level: np.ndarray,  # [4] fx fy cx cy at the pyramid level
    cfg: RefinementConfig,
    width: int,
    height: int,
    voxel_size: float,
    thres_shell: float,
    depths: Optional[np.ndarray],  # [K, H, W] level depth maps
    *,
    budget: Optional[float] = None,
    bytes_per_element: float = _EG_DENSE_BYTES_PER_ELEMENT,
    device="cuda",
) -> Tuple[Optional[np.ndarray], str, int]:
    """The E_g element layout of one (grid, pyramid) level, by the JAX
    package's rules (`intrinsic3d_tpu/refine/optimizer.py::plan_eg_layout`).

    Returns `(bmap, reason, eg_chunks)`: `bmap=None` keeps the dense
    frame-major `[K, nb, B³]` elements; a `bmap [K, NBc]` asks for frame
    buckets (`build_frame_buckets`), and `eg_chunks > 1` for the
    linearization streamed over frame chunks. Rules: bucketing wins on speed
    when the exact bucket layout halves the blocks; `frame_bucketing=
    "capped"` also tries a per-block frame cap for speed; bucketing is forced
    when the dense fields exceed `budget` (default `eg_hbm_budget(device)`),
    then streamed when even the exact buckets do not fit, then frame-capped
    and trimmed to the budget as a last resort. `bytes_per_element` is the
    dense layout's peak bytes per element."""
    if cfg.frame_bucketing == "never":
        return None, "dense (bucketing disabled)", 1
    if budget is None:
        budget = eg_hbm_budget(device)
    k = int(poses.shape[0])
    s = layout.block**3
    nb = layout.num_blocks
    use_depth_cull = depths is not None and cfg.occlusion_distance > 0.0
    common = dict(
        layout=layout,
        poses6=np.asarray(poses),
        intr4=np.asarray(intr_level, np.float64),
        width=width,
        height=height,
        voxel_size=voxel_size,
        depths=np.asarray(depths) if use_depth_cull else None,
        occlusion=cfg.occlusion_distance,
        depth_slack=0.05 + float(thres_shell),
    )
    fb = build_frame_buckets(**common, margin_px=0.15 * max(width, height))
    dense_bytes = k * nb * s * bytes_per_element
    win_speed = 2 * fb.shape[1] <= nb
    win_memory = dense_bytes > budget and fb.shape[1] < nb
    reason = "memory-forced" if (win_memory and not win_speed) else ("speed" if win_speed else "forced by config")
    cap = cfg.num_observations + 3
    if cfg.frame_bucketing == "capped" and not (win_speed or win_memory) and k > cap:
        fbc = build_frame_buckets(**common, margin_px=0.15 * max(width, height), max_frames_per_block=cap)
        if 2 * fbc.shape[1] <= nb:
            return fbc, f"speed, frame-capped at {cap} (opt-in)", 1
    if not (cfg.frame_bucketing == "always" or win_speed or win_memory):
        return None, "dense (full frame coverage, fits HBM)", 1
    bucket_bytes = k * fb.shape[1] * s * bytes_per_element
    if bucket_bytes > budget:
        # the exact buckets do not fit one-shot: stream them over frame
        # chunks when the persistent fields and the assembly fit
        el = k * fb.shape[1] * s
        persist = el * _EG_CHUNK_PERSIST_BYTES
        assembly = el * _EG_ASSEMBLY_BYTES
        per_frame_t = fb.shape[1] * s * _EG_CHUNK_TRANSIENT_BYTES
        if persist < budget and assembly <= budget:
            f_max = int((budget - persist) // per_frame_t)
            if f_max >= 1:
                chunks = -(-k // f_max)
                if chunks > 1:
                    log.info(
                        "  E_g exact layout streamed in %d frame chunks (%.1f GB persistent + %.1f GB/chunk "
                        "transient + %.1f GB assembly <= %.1f GB budget; full %d-block coverage kept)",
                        chunks, persist / 1e9, min(f_max, k) * per_frame_t / 1e9, assembly / 1e9, budget / 1e9,
                        fb.shape[1],
                    )
                    return fb, reason + f", streamed in {chunks} chunks", chunks
        # last resort: per-block frame cap, halved margin and a hard
        # per-frame trim to the budget
        trim_bytes = min(bytes_per_element, _EG_BUCKET_BYTES_PER_ELEMENT)
        b_max = bucket_ladder_down(max(8, int(budget // (k * s * trim_bytes))))
        trim_stats: dict = {}
        fb = build_frame_buckets(
            **common,
            margin_px=0.08 * max(width, height),
            max_frames_per_block=min(cfg.num_observations + 1, k),
            max_blocks_per_frame=b_max,
            protect_cover=cfg.num_observations,
            stats=trim_stats,
        )
        reason += ", frame-capped"
        if trim_stats.get("trimmed_pairs", 0):
            reason += f", trimmed to {b_max} blocks/frame"
    return fb, reason, 1


def fused_outer_step(
    st,
    sdf_plan,
    alb_plan,
    bparams,
    depths,
    images,
    pyr_scale,
    voxel_size,
    truncation,
    thres_shell,
    occlusion_distance,
    lambdas,
    mu,
    *,
    num_obs: int,
    width: int,
    height: int,
    fix_poses: bool,
    fix_intrinsics: bool,
    fix_distortion: bool,
    use_albedo: bool,
    lm_steps: int,
    cg_iters: int,
    schur_globals=False,
    min_pose_obs: int = 0,
    cg_coeff_dtype: str = "bfloat16",
    cg_eta: float = 0.1,
    bmap: Optional[torch.Tensor] = None,
    eg_chunks: int = 1,
    device="cuda",
):
    """One outer iteration of the refinement (``optimizer.cpp:119-173``):
    re-collect observations and rebuild the problem at the current
    parameters, then relinearize, solve and accept. `bmap` (frame buckets,
    on `device`) passes to `device_assembly`; `cg_coeff_dtype`, `cg_eta` and
    `eg_chunks` pass through to `gn_iteration`. The assembly runs in a
    `solve.assemble` span.

    Returns (params', cost_before, cost_after, mu', num_tries)."""
    with span("solve.assemble"):
        basm, bmasks = device_assembly(
            st,
            sdf_plan,
            alb_plan,
            bparams,
            depths,
            images,
            pyr_scale,
            voxel_size,
            truncation,
            thres_shell,
            occlusion_distance,
            lambdas,
            num_obs=num_obs,
            width=width,
            height=height,
            fix_poses=fix_poses,
            fix_intrinsics=fix_intrinsics,
            fix_distortion=fix_distortion,
            use_albedo=use_albedo,
            bmap=bmap,
            min_pose_obs=min_pose_obs,
            device=device,
        )
    return gn_iteration(
        bparams, basm, bmasks, mu, lm_steps, cg_iters,
        cg_coeff_dtype=cg_coeff_dtype, schur_globals=schur_globals, cg_eta=cg_eta, eg_chunks=eg_chunks,
        device=device,
    )


def level_schur(cfg: RefinementConfig):
    """`gn_iteration`'s `schur_globals` for the level solves of `cfg`: with
    `cfg.schur_globals` the poses are eliminated exactly, and the camera's
    intrinsics and distortion with them only while the camera is held.
    Free, the camera stays in the PCG ("poses"), as in the reference's
    joint CGNR. Its 9 columns are dense over every element and couple every
    frame's pose, and some directions of that coupling are barely observed
    (the focal length against the cameras' distance, the principal point
    against their rotation). On the observations of one outer step the
    energy still falls far along them: the exact elimination steps there,
    and the observations the next outer steps collect through that camera
    hold fewer and fewer of the frames' points. Measured on an H100 on the
    `orbit10kf-globals` capture: fx 591.7 → 680 → 966 in two steps, no
    element of any LM try leaving the images, and no E_g element left from
    the third step on; in the PCG, fx ends near 579. Only the PCG's early
    exit (12 steps, η = 0.1) holds the camera back: at converged settings
    the two take the same step."""
    if not cfg.schur_globals:
        return False
    return True if cfg.fix_intrinsics and cfg.fix_distortion else "poses"


class LevelSetup(NamedTuple):
    """What every outer step of one (grid, pyramid) level shares."""

    layout: BlockLayout
    static: LevelStatic
    sdf_plan: ShiftPlan
    alb_plan: ShiftPlan
    params: Params  # block-dense start point ([nb+1, B³] voxel fields)
    scalars: Tuple[float, ...]  # pyr_scale, voxel_size, truncation, thres_shell, occlusion_distance
    lambdas: torch.Tensor  # [4] raw (λ_g, λ_r, λ_s, λ_a)
    assembly_kw: dict  # num_obs, width, height, fix_*, use_albedo
    device: torch.device
    bmap: Optional[torch.Tensor] = None  # [K, NBc] frame buckets on `device`, or None (dense)
    eg_chunks: int = 1  # frame chunks of the streamed linearization (1 = one-shot)

    def assemble(self, params: Params, depths, images):
        """`device_assembly` at `params`: (BlockAssembly, Masks)."""
        return device_assembly(
            self.static, self.sdf_plan, self.alb_plan, params, depths, images, *self.scalars,
            self.lambdas, **self.assembly_kw, bmap=self.bmap, device=self.device,
        )

    def outer_step(self, params: Params, depths, images, mu, **solver):
        """`fused_outer_step` at `params` in the level's element layout;
        `solver` holds lm_steps, cg_iters and the optional solver settings."""
        return fused_outer_step(
            self.static, self.sdf_plan, self.alb_plan, params, depths, images, *self.scalars,
            self.lambdas, mu, **self.assembly_kw, **solver, bmap=self.bmap, eg_chunks=self.eg_chunks,
            device=self.device,
        )


def _bmap_on(fb: Optional[np.ndarray], dev: torch.device) -> Optional[torch.Tensor]:
    """Host frame buckets → the int64 index tensor the element transport reads."""
    return None if fb is None else torch.as_tensor(np.asarray(fb, np.int64), device=dev)


def prepare_level(
    grid: VoxelGrid,
    topo: LevelTopology,
    voxel_sh: np.ndarray,
    params: Params,  # table-order sdf/albedo
    cfg: RefinementConfig,
    thres_shell: float,
    width: int,
    height: int,
    lambdas,
    pyr_scale: float = 1.0,
    device="cuda",
    layout: Optional[BlockLayout] = None,
    bmap: Optional[np.ndarray] = None,
    eg_chunks: int = 1,
    static: Optional[LevelStatic] = None,
) -> LevelSetup:
    """Block layout (built unless given), level statics, shift plans and
    block-dense parameters of one level, on `device`. `lambdas` are the raw
    (λ_g, λ_r, λ_s, λ_a); `bmap` (host frame buckets, `plan_eg_layout`'s) and
    `eg_chunks` set the E_g element layout. The statics come from
    `build_level_static` (on a CUDA device the `level_static` kernel, which
    needs no `topo`; elsewhere the host build from `topo` and `voxel_sh`),
    or `static` (a host static of `layout`, `level_static_host`'s) is
    uploaded instead; either under a `level_setup.static` span."""
    dev = resolve_device(device)
    if layout is None:
        layout = BlockLayout.build(grid)
    with span("level_setup.static"):
        if static is None:
            static = build_level_static(layout, grid, topo, voxel_sh, dev)
        else:
            static = upload_level_static(static, dev)
    sdf_plan, alb_plan = layout_plans(layout, dev)
    return LevelSetup(
        layout=layout,
        static=static,
        sdf_plan=sdf_plan,
        alb_plan=alb_plan,
        params=params._replace(
            sdf=table_to_dense(layout, params.sdf), albedo=table_to_dense(layout, params.albedo)
        ),
        scalars=(pyr_scale, grid.voxel_size, grid.truncation, thres_shell, cfg.occlusion_distance),
        lambdas=torch.as_tensor(lambdas, dtype=torch.float32, device=dev),
        assembly_kw=dict(
            num_obs=cfg.num_observations, width=width, height=height, fix_poses=cfg.fix_poses,
            fix_intrinsics=cfg.fix_intrinsics, fix_distortion=cfg.fix_distortion, use_albedo=cfg.lambda_a >= 0.0,
        ),
        device=dev,
        bmap=_bmap_on(bmap, dev),
        eg_chunks=eg_chunks,
    )


class PlanInputs(NamedTuple):
    """Host copies of what `plan_eg_layout` reads of a level's parameters
    and images, made on the calling thread."""

    poses: np.ndarray  # [K, 6]
    intr: np.ndarray  # [4] float64 fx fy cx cy at the pyramid level
    depths: Optional[np.ndarray]  # [K, H, W] level depth maps, or None (no occlusion culling)
    width: int
    height: int


def plan_inputs(params: Params, depths_host: Optional[np.ndarray], width: int, height: int,
                rgbd_level: int) -> PlanInputs:
    """`PlanInputs` of a level: the poses and the intrinsics at the pyramid
    level pulled to numpy (a device sync on the card), with the level's
    host depth maps."""
    return PlanInputs(
        poses=params.poses.detach().cpu().numpy(),
        intr=params.intr.detach().cpu().numpy().astype(np.float64) * pyramid_level_to_scale(rgbd_level),
        depths=depths_host,
        width=width,
        height=height,
    )


def _plan_level(layout: BlockLayout, inputs: PlanInputs, cfg: RefinementConfig, voxel_size: float,
                thres_shell: float, budget: float):
    """`plan_eg_layout` of a level from its host inputs: numpy only, so the
    serial path and a `LevelPrep` thread run the same code."""
    return plan_eg_layout(
        layout, inputs.poses, inputs.intr, cfg, inputs.width, inputs.height, voxel_size, thres_shell,
        inputs.depths if cfg.occlusion_distance > 0.0 else None, budget=budget,
    )


class LevelPrep(HostPrep):
    """A level's host half, built on a background thread: the counterpart of
    `intrinsic3d_tpu/refine/optimizer.py::LevelPrep` without its program
    warm-up.

    Started before the level's lighting estimate (which needs only the
    normal stencil `nbr4`), the thread builds what `optimize_level` would
    build after it: the `BlockLayout` (unless `layout` is given) and the
    `plan_eg_layout` decision `(bmap, reason, eg_chunks)` against `budget`.
    Where the level builds its statics on the host (a CPU level, or a rank
    of `mesh`: not `statics_on_card` of the params' device), it builds
    `level_topology(grid)` too (unless `topo` is given; memoized per grid;
    on a second thread, beside the layout and the plan) and the level
    statics with zero SH (`level_static_host`); `optimize_level(prep=)`
    joins it, writes the real per-voxel SH into the statics and uploads
    them on the calling thread. A single-device level on a CUDA device
    builds its statics on the card after the join, from the layout alone.
    `program_only=True` (the next pyramid level of the coarsest grid,
    started while the current one recolors and the grid's colors still
    change) plans only and reuses `layout`; the level then builds its
    statics itself.

    The constructor, on the calling thread, pulls the poses and intrinsics
    to numpy; `depths_host` is the level's depth maps already on the host
    and `budget` a number (`level_budget`), so the thread calls nothing of
    CUDA. Its products are numpy arrays and host objects: `layout`, `plan`,
    `topo` and `static` (None where the prep builds no host statics), and
    the depth pixels its plan scanned, `depth_px`."""

    def __init__(
        self,
        grid: VoxelGrid,
        topo: Optional[LevelTopology],
        params: Params,
        cfg: RefinementConfig,
        depths_host: np.ndarray,  # [K, H, W] the level's depth maps on the host
        thres_shell: float,
        rgbd_level: int,
        *,
        budget: float,
        layout: Optional[BlockLayout] = None,
        mesh=None,
        program_only: bool = False,
    ):
        if program_only and layout is None:
            raise ValueError("a program_only prep reuses the level's layout: pass layout=")
        self.grid = grid
        self.topo = topo
        self.layout = layout
        self.rgbd_level = rgbd_level
        self.budget = float(budget)
        self.host_static = not program_only and not statics_on_card(params.sdf.device, mesh)
        h, w = int(depths_host.shape[1]), int(depths_host.shape[2])
        self.inputs = plan_inputs(params, depths_host, w, h, rgbd_level)
        self.plan = None  # (bmap [K, NBc] int32 or None, reason, eg_chunks)
        self.depth_px = 0
        self.static = None  # LevelStatic of numpy arrays, zero SH
        self._cfg = cfg
        self._thres_shell = float(thres_shell)
        self._blocks_multiple = 8 if mesh is None else max(8, mesh.size)
        super().__init__(f"level p{rgbd_level}v{grid.num_voxels}")

    def _prepare(self) -> None:
        grid = self.grid
        # the stencil tables (mostly the native library, which runs without
        # the GIL) on a second thread beside the layout and the plan
        tables = _TopologyPrep(grid) if self.topo is None and self.host_static else None
        try:
            if self.layout is None:
                self.layout = BlockLayout.build(grid, blocks_multiple=self._blocks_multiple)
            scanned = depth_pixels_scanned()
            self.plan = _plan_level(self.layout, self.inputs, self._cfg, grid.voxel_size, self._thres_shell,
                                    self.budget)
            self.depth_px = depth_pixels_scanned() - scanned
        finally:
            if tables is not None:
                tables.wait()
        if self.host_static:
            if tables is not None:
                self.topo = tables.result().topo
            self.static = level_static_host(self.layout, grid, self.topo, None)


class _TopologyPrep(HostPrep):
    """`level_topology(grid)` on a thread of its own (inside a `LevelPrep`)."""

    def __init__(self, grid: VoxelGrid):
        self.grid = grid
        self.topo = None
        super().__init__(f"topology v{grid.num_voxels}")

    def _prepare(self) -> None:
        self.topo = level_topology(self.grid)


@dataclasses.dataclass
class OptimizeStats:
    """Per-iteration record of one level (the JAX package's fields first),
    plus the level's plan and sizes (`bucket_blocks`: blocks per frame row
    of a bucketed plan, 0 dense; `elements`: the E_g elements K·kb·B³, or
    the flat table's last assembly's), its setup and iteration seconds (host
    clock; every iteration ends on a host read of its costs), the seconds
    of its `LevelPrep` thread (0 without one), its device-to-host reads
    from its first outer step to its last (`timer.HOST_READS`, every site;
    the flat table's `.cpu()` pulls of the intrinsics are not counted), its
    E_g passes (`blockform.EG_PASSES`: one a frame chunk of a linearization
    or an acceptance cost, through the E_g kernel or eager), the depth
    pixels its plans' depth culling scanned (`plan_depth_px`: the level's
    depth maps once a frame-bucket pass, on the prep's thread or its own)
    and, on the card, its peak allocated bytes."""

    costs_before: list
    costs_after: list
    tries: list
    mus: list = dataclasses.field(default_factory=list)
    reason: str = ""
    num_blocks: int = 0
    bucket_blocks: int = 0
    eg_chunks: int = 1
    elements: int = 0
    setup_seconds: float = 0.0
    prefetch_seconds: float = 0.0
    iter_seconds: list = dataclasses.field(default_factory=list)
    host_reads: int = 0
    eg_fused: int = 0
    eg_eager: int = 0
    plan_depth_px: int = 0
    peak_bytes: int = 0
    brick_rows: int = 0  # under a mesh: the rank's block rows m
    halo_rows: tuple = ()  # under a mesh: rows exchanged per active mesh shift
    placement: list = dataclasses.field(default_factory=list)  # under a mesh: `SpmdLevel.placement()`


def optimize_level(
    grid: VoxelGrid,
    topo: Optional[LevelTopology],
    params: Params,  # table-order sdf/albedo on `device`
    cfg: RefinementConfig,
    base_cam: Camera,
    depths_level: torch.Tensor,  # [K, H, W]
    images_level: torch.Tensor,  # [K, H, W] intensity
    voxel_sh: Optional[np.ndarray],  # [N, 9]; None under a mesh with `eg_sh`
    thres_shell: float,
    rgbd_level: int,
    mu0: float = 1e-4,
    cg_iters: int = 12,
    budget: Optional[float] = None,
    cg_coeff_dtype: str = "bfloat16",
    cg_eta: float = 0.1,
    use_blocks: bool = True,
    device="cuda",
    mesh=None,
    ctx=None,
    eg_sh: Optional[torch.Tensor] = None,
    prep: Optional[LevelPrep] = None,
) -> Tuple[Params, float, OptimizeStats]:
    """Run `cfg.iterations` relinearized GN steps of one (grid, pyramid)
    level on `device`; returns the updated table-order params, the final
    damping (the next level's start, the reference's trust-region warm
    start) and the level's `OptimizeStats`.

    With `use_blocks` (the production path) the level runs on the
    block-dense layout with the per-iteration device assembly; λ_r and λ_s
    follow `compute_varying_lambda` over the iterations. `plan_eg_layout`
    decides the E_g element layout against `budget` (default:
    `eg_hbm_budget(device)`). When the first outer step runs out of device
    memory (`torch.cuda.OutOfMemoryError`), the failed attempt's memory is
    released, the layout is replanned at 60% of that budget and the step
    retried once, as the JAX package does; a second out-of-memory error,
    one at a later iteration, or any other error propagates, and no work
    moves to the CPU. `cg_coeff_dtype` and `cg_eta` pass through to
    `gn_iteration` (the JAX level loop runs its defaults).

    `use_blocks=False` runs the flat-table oracle: every iteration rebuilds
    `build_assembly` with the camera of the current intrinsics and
    distortion and takes one flat `gn_iteration` (exact products, joint
    PCG; `budget` and `cg_coeff_dtype` do not apply).

    `mesh` (a `parallel.sharding.Mesh`; every rank calls with the same
    arguments) runs the block path spatially sharded on the mesh's device:
    the layout's block count is a multiple of max(8, ranks), each rank steps
    its brick through `parallel.spmd.SpmdLevel` (device assembly and solve,
    halo'd stencils, all-reduced globals) and the result is gathered back to
    every rank. The default budget is the mesh's: one card's times the
    ranks over the ranks sharing a card, as the element fields split about
    1/n a rank. A streamed plan (`eg_chunks > 1`) streams each rank's
    brick; a step out of memory is not replanned. `ctx` (a
    `parallel.spmd.SpmdContext` of this grid) reuses its layout and halo
    plans, and `eg_sh` (this rank's `[9, m, B³]` per-voxel SH on that
    layout, `SpmdStages.svsh`) replaces `voxel_sh`: the multi-device level
    loop (`refine.mesh_pipeline.MeshLevelRunner`) passes both, so the
    level's per-voxel SH is never whole on one rank.

    `prep` (a `LevelPrep` of this grid and pyramid level, block path only)
    supplies the layout and the plan built in the background, and where the
    level builds its statics on the host the topology and the host statics:
    the level joins it (its exception re-raises here), writes `voxel_sh`
    into the statics and uploads them. A single-device level on a CUDA
    device (`statics_on_card`), with a prep or without, builds its statics
    on the card from the layout (`build_level_static`). The results are
    bitwise those of the serial build. Its thread's seconds are recorded
    under `prefetch[p{r}v{n}]`; `level_setup` is this thread's, the wait at
    the join (a `join[...]` span) included. A `budget` given with a prep
    must be the prep's.

    On the card the peak-memory counter is reset at the start, so
    `peak_bytes` is this level's peak. `base_cam` is unused, as in the JAX
    package."""
    del base_cam
    dev = mesh.device if mesh is not None else resolve_device(device)
    if mesh is not None and not use_blocks:
        raise ValueError("optimize_level(mesh=...) runs the block layout only")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    pyr_scale = pyramid_level_to_scale(rgbd_level)
    h, w = int(depths_level.shape[1]), int(depths_level.shape[2])
    k = int(params.poses.shape[0])
    tag = f"p{rgbd_level}v{grid.num_voxels}"
    stats = OptimizeStats([], [], [])

    def lambdas_at(itr):
        lambda_r = compute_varying_lambda(itr, cfg.iterations, cfg.lambda_r0, cfg.lambda_r1)
        lambda_s = compute_varying_lambda(itr, cfg.iterations, cfg.lambda_s0, cfg.lambda_s1)
        return lambda_r, lambda_s

    def record_iteration(itr, t0, out):
        _, cost0, cost1, mu, tries = out
        HOST_READS["iteration_record"] += 3  # the costs and the damping below
        stats.costs_before.append(float(cost0))
        stats.costs_after.append(float(cost1))
        stats.tries.append(int(tries))
        stats.mus.append(float(mu))
        stats.iter_seconds.append(time.perf_counter() - t0)
        log.info(
            "   iter %d: cost %.6e -> %.6e (lm tries %d, mu %.2e)",
            itr, stats.costs_before[-1], stats.costs_after[-1], stats.tries[-1], stats.mus[-1],
        )

    def record_reads(reads0, passes0):
        stats.host_reads = host_reads() - reads0
        stats.eg_fused = EG_PASSES["fused"] - passes0["fused"]
        stats.eg_eager = EG_PASSES["eager"] - passes0["eager"]

    def finish(mu):
        if dev.type == "cuda":
            stats.peak_bytes = int(torch.cuda.max_memory_allocated(dev))
        return float(mu)

    mu = torch.tensor(mu0, dtype=torch.float32, device=dev)
    if not use_blocks:
        t0 = time.perf_counter()
        topo = level_topology(grid) if topo is None else topo
        stats.reason = "flat table"
        stats.setup_seconds = time.perf_counter() - t0
        reads0, passes0 = host_reads(), dict(EG_PASSES)
        with span(f"solve[{tag}]", phase=True):
            for itr in range(cfg.iterations):
                t0 = time.perf_counter()
                lambda_r, lambda_s = lambdas_at(itr)
                with span("solve.assemble"):
                    # observations through the CURRENT intrinsics and distortion
                    intr = params.intr.detach().cpu().numpy()
                    cam_level = Camera.create(
                        intr[0] * pyr_scale, intr[1] * pyr_scale, intr[2] * pyr_scale, intr[3] * pyr_scale, w, h,
                        dist=params.dist.detach().cpu().numpy(),
                    )
                    asm, masks = build_assembly(
                        grid, topo, params, cam_level, depths_level, images_level, voxel_sh, thres_shell,
                        cfg.occlusion_distance, cfg.num_observations, cfg.lambda_g, lambda_r, lambda_s, cfg.lambda_a,
                        pyr_scale, cfg.fix_poses, cfg.fix_intrinsics, cfg.fix_distortion,
                        min_pose_obs=cfg.min_pose_obs, device=dev,
                    )
                stats.elements = int(asm.eg_w.shape[0])
                out = gn_iteration(
                    params, asm, masks, mu, cfg.lm_steps, cg_iters, schur_globals=cfg.schur_globals, cg_eta=cg_eta,
                    device=dev,
                )
                params, mu = out[0], out[3]
                record_iteration(itr, t0, out)
        record_reads(reads0, passes0)
        return params, finish(mu), stats

    inputs = None
    layout = None

    def plan(at_budget):
        nonlocal inputs
        if inputs is None:
            depths_host = depths_level.cpu().numpy() if cfg.occlusion_distance > 0.0 else None
            inputs = plan_inputs(params, depths_host, w, h, rgbd_level)
        scanned = depth_pixels_scanned()
        out = _plan_level(layout, inputs, cfg, grid.voxel_size, thres_shell, at_budget)
        stats.plan_depth_px += depth_pixels_scanned() - scanned
        return out

    def record_plan(fb, reason, eg_chunks):
        stats.reason = reason
        stats.bucket_blocks = 0 if fb is None else int(fb.shape[1])
        stats.eg_chunks = eg_chunks
        stats.elements = k * (stats.bucket_blocks or layout.num_blocks) * layout.block**3
        if fb is not None:
            log.info(
                "  frame buckets: %d blocks/frame of %d (%.0f%% coverage, %s)",
                fb.shape[1], layout.num_blocks, 100.0 * fb.shape[1] / layout.num_blocks, reason,
            )

    with span(f"level_setup[{tag}]", phase=True) as setup:
        if prep is not None:
            prep.join()
            if prep.grid is not grid or prep.rgbd_level != rgbd_level:
                raise ValueError(f"the prep is for another level than p{rgbd_level} of this grid")
            if budget is not None and budget != prep.budget:
                raise ValueError(f"budget {budget} differs from the prep's {prep.budget}")
            if ctx is not None and prep.layout is not ctx.layout:
                raise ValueError("the prep's layout is not the mesh context's")
            layout, budget, inputs = prep.layout, prep.budget, prep.inputs
            stats.prefetch_seconds = prep.seconds
            stats.plan_depth_px = prep.depth_px
            record_phase(f"prefetch[{tag}]", prep.seconds)
        elif ctx is not None:
            layout = ctx.layout
        else:
            layout = BlockLayout.build(grid, blocks_multiple=8 if mesh is None else max(8, mesh.size))
        if budget is None:
            budget = level_budget(dev, mesh)

        fb, reason, eg_chunks = prep.plan if prep is not None else plan(budget)
        # the statics: on the card from the layout, or the host statics
        # (under a mesh with `eg_sh` they carry zero SH: the rank's own
        # per-voxel SH replaces them on the card)
        sh = voxel_sh if eg_sh is None else None
        if statics_on_card(dev, mesh):
            host = None
        elif prep is not None and prep.static is not None:
            host = prep.static if sh is None else fill_voxel_sh(prep.static, layout, sh)
        else:
            topo = level_topology(grid) if topo is None else topo
            host = level_static_host(layout, grid, topo, sh)
        if mesh is None:
            level = prepare_level(
                grid, None, sh, params, cfg, thres_shell, w, h,
                lambdas=(cfg.lambda_g, cfg.lambda_r0, cfg.lambda_s0, cfg.lambda_a), pyr_scale=pyr_scale,
                device=dev, layout=layout, bmap=fb, eg_chunks=eg_chunks, static=host,
            )
            bparams = level.params
        else:
            level = _spmd_level(mesh, ctx, layout, grid, host, eg_sh, cfg, thres_shell, pyr_scale, w, h,
                                fb, eg_chunks, depths_level, images_level, cg_iters, cg_coeff_dtype, cg_eta)
            bparams = level.begin(
                params._replace(sdf=table_to_dense(layout, params.sdf), albedo=table_to_dense(layout, params.albedo))
            )
            stats.brick_rows = level.ctx.m
            stats.halo_rows = tuple(level.ctx.halo.hs)
            stats.placement = level.placement()
        record_plan(fb, reason, eg_chunks)
        stats.num_blocks = layout.num_blocks
    stats.setup_seconds = setup.seconds
    log.info(
        "   level setup: %.2fs (%d blocks, %d voxels, %d elements, %s)",
        stats.setup_seconds, layout.num_blocks, grid.num_voxels, stats.elements, reason,
    )

    solver = dict(
        lm_steps=cfg.lm_steps, cg_iters=cg_iters, schur_globals=level_schur(cfg), min_pose_obs=cfg.min_pose_obs,
        cg_coeff_dtype=cg_coeff_dtype, cg_eta=cg_eta,
    )
    reads0, passes0 = host_reads(), dict(EG_PASSES)
    with span(f"solve[{tag}]", phase=True):
        for itr in range(cfg.iterations):
            t0 = time.perf_counter()
            lambda_r, lambda_s = lambdas_at(itr)
            lambdas = torch.tensor([cfg.lambda_g, lambda_r, lambda_s, cfg.lambda_a], dtype=torch.float32,
                                   device=dev)
            if mesh is not None:
                out = level.step(bparams, lambdas, mu)
                bparams, mu = out[0], out[3]
                record_iteration(itr, t0, out)
                continue
            out_of_memory = None
            try:
                out = level._replace(lambdas=lambdas).outer_step(bparams, depths_level, images_level, mu, **solver)
            except torch.cuda.OutOfMemoryError as exc:
                if itr != 0:
                    raise
                out_of_memory = str(exc)
            if out_of_memory is not None:
                # the plan exceeded the card's real memory (mis-calibrated
                # constants): with the failed attempt's tensors released (the
                # exception and its frames are gone here), replan at 60% of the
                # budget — more chunks, or the frame cap — and retry ONCE
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                log.warning(
                    "level step exhausted device memory (%s...); replanning the E_g layout at 60%% budget",
                    out_of_memory[:200],
                )
                fb, reason, eg_chunks = plan(0.6 * budget)
                log.warning(
                    "  retry layout: %s (%s, %d chunks)",
                    "dense" if fb is None else f"{fb.shape[1]} blocks/frame", reason, eg_chunks,
                )
                record_plan(fb, reason, eg_chunks)
                level = level._replace(bmap=_bmap_on(fb, dev), eg_chunks=eg_chunks)
                out = level._replace(lambdas=lambdas).outer_step(bparams, depths_level, images_level, mu, **solver)
            bparams, mu = out[0], out[3]
            record_iteration(itr, t0, out)
    record_reads(reads0, passes0)
    if mesh is not None:
        bparams = level.finish(bparams)
    return params_from_block(layout, bparams), finish(mu), stats


def _spmd_level(mesh, ctx, layout, grid, host, eg_sh, cfg, thres_shell, pyr_scale, w, h, fb, eg_chunks,
                depths_level, images_level, cg_iters, cg_coeff_dtype, cg_eta):
    """This rank's `SpmdLevel` of one level: the host statics `host` (zero
    SH with `eg_sh`, the rank's own per-voxel SH) sliced to the rank's
    brick. It places tensors on the card, so it runs on the main thread
    after a prep's join."""
    from intrinsic3d_torch.parallel.spmd import SpmdLevel

    return SpmdLevel(
        mesh, layout, upload_level_static(host, "cpu"), depths_level, images_level,
        num_obs=cfg.num_observations, width=w, height=h, pyr_scale=float(pyr_scale),
        voxel_size=float(grid.voxel_size), truncation=float(grid.truncation), thres_shell=float(thres_shell),
        occlusion_distance=float(cfg.occlusion_distance), fix_poses=cfg.fix_poses,
        fix_intrinsics=cfg.fix_intrinsics, fix_distortion=cfg.fix_distortion, use_albedo=cfg.lambda_a >= 0.0,
        bmap=fb, lm_steps=cfg.lm_steps, cg_iters=cg_iters, cg_coeff_dtype=cg_coeff_dtype, cg_eta=cg_eta, ctx=ctx,
        eg_sh_device=eg_sh, schur_globals=level_schur(cfg), min_pose_obs=cfg.min_pose_obs, eg_chunks=eg_chunks,
    )

