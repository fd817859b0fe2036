"""Per-level gather topology and albedo chromaticity weights (host numpy).

Copy of `intrinsic3d_tpu/refine/assembly.py::LevelTopology` and
`chroma_weights` (reference ``optimizer.cpp:176-282``,
``albedo_regularizer.cpp:60-72``) and the per-grid memo `level_topology`.
The flat-table `build_assembly` is not ported (it is the JAX package's
equivalence oracle, not on the pipeline's path).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from intrinsic3d_torch.grid.voxel_grid import (
    EG_ALBEDO_OFFSETS,
    EG_SDF_OFFSETS,
    NORMAL_OFFSETS,
    RING6_OFFSETS,
    VoxelGrid,
)


@dataclasses.dataclass
class LevelTopology:
    """Gather tables fixed for one grid level (the active set is frozen)."""

    eg_sdf10_idx: np.ndarray  # [N, 10]
    eg_alb4_idx: np.ndarray  # [N, 4]
    ring6_idx: np.ndarray  # [N, 6]
    nbr4_idx: np.ndarray  # [N, 4] normal stencil
    ea_pairs: np.ndarray  # [P, 2] unique undirected 6-ring pairs
    coords: np.ndarray  # [N, 3]

    @classmethod
    def build(cls, grid: VoxelGrid) -> "LevelTopology":
        ring6 = grid.neighbor_table(RING6_OFFSETS)
        # every undirected adjacency (i, j) appears once from each endpoint;
        # keeping src < dst dedups (the reference's voxels_added bookkeeping,
        # ``optimizer.cpp:268-274``), ordered as np.unique(axis=0) would
        src = np.repeat(np.arange(grid.num_voxels), 6)
        dst = ring6.reshape(-1)
        ok = dst > src  # absent neighbours are −1, excluded by > src ≥ 0
        pairs = np.stack([src[ok], dst[ok]], axis=-1)
        pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))].astype(np.int32)
        return cls(
            eg_sdf10_idx=grid.neighbor_table(EG_SDF_OFFSETS),
            eg_alb4_idx=grid.neighbor_table(EG_ALBEDO_OFFSETS),
            ring6_idx=ring6,
            nbr4_idx=grid.neighbor_table(NORMAL_OFFSETS),
            ea_pairs=pairs,
            coords=grid.coords.astype(np.int32),
        )


def level_topology(grid: VoxelGrid) -> LevelTopology:
    """`LevelTopology.build` memoized per grid object. A grid's coordinates
    never change (structural passes return new grids), so the tables never
    go stale; every pyramid level of a grid level reuses them."""
    topo = grid.__dict__.get("_topo_cache")
    if topo is None:
        topo = LevelTopology.build(grid)
        grid._topo_cache = topo
    return topo


def chroma_weights(colors: np.ndarray, pairs: np.ndarray) -> np.ndarray:
    """Chromaticity-difference weights of albedo pairs
    (``albedo_regularizer.cpp:60-72``); colors are 0..255 RGB. The reference
    divides [0,1]-scaled color by the [0,255]-scaled luma — kept verbatim."""
    c01 = colors / 255.0
    lum255 = 0.299 * colors[:, 0] + 0.587 * colors[:, 1] + 0.114 * colors[:, 2]
    lum255 = np.where(lum255 == 0.0, 1e-12, lum255)
    chroma = c01 / lum255[:, None]
    d = np.linalg.norm(chroma[pairs[:, 0]] - chroma[pairs[:, 1]], axis=-1)
    w = np.maximum(1.0 - d, 0.01)
    return np.where(np.isfinite(w), w, 0.0).astype(np.float32)
