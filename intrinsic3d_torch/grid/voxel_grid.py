"""Flat sorted voxel table (host numpy).

Copy of `intrinsic3d_tpu/grid/voxel_grid.py`: packed coordinate keys, the
stencil offset tables, `find_indices` by vectorized binary search, and the
`VoxelGrid` record with its structural helpers and `.tsdf` I/O. The grid's
own neighbor tables and lookups go through the native host library
(`intrinsic3d_torch.native`), as in the JAX package; `find_indices` is their
plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from intrinsic3d_torch import native
from intrinsic3d_torch.io.tsdf_io import TsdfVolume, load_tsdf, save_tsdf

# 21 bits per axis, offset so coordinates in [-2^20, 2^20) pack monotonically
_BIAS = 1 << 20
_MASK_BITS = 21


def pack_coords(coords: np.ndarray) -> np.ndarray:
    """Pack int voxel coords `[N, 3]` into sortable int64 keys."""
    c = coords.astype(np.int64) + _BIAS
    if np.any((c < 0) | (c >= (1 << _MASK_BITS))):
        raise ValueError("voxel coordinates out of packable range ±2^20")
    return (c[:, 0] << (2 * _MASK_BITS)) | (c[:, 1] << _MASK_BITS) | c[:, 2]


def unpack_keys(keys: np.ndarray) -> np.ndarray:
    m = (1 << _MASK_BITS) - 1
    x = (keys >> (2 * _MASK_BITS)) & m
    y = (keys >> _MASK_BITS) & m
    z = keys & m
    return np.stack([x, y, z], axis=-1).astype(np.int64) - _BIAS


def find_indices(sorted_keys: np.ndarray, query_coords: np.ndarray) -> np.ndarray:
    """Indices of query voxel coords `[..., 3]` in the table; −1 where absent."""
    shape = query_coords.shape[:-1]
    q = query_coords.reshape(-1, 3)
    qk = pack_coords(q)
    if len(sorted_keys) == 0:
        return np.full(shape, -1, np.int32)
    pos = np.searchsorted(sorted_keys, qk)
    pos_c = np.clip(pos, 0, len(sorted_keys) - 1)
    hit = (pos < len(sorted_keys)) & (sorted_keys[pos_c] == qk)
    return np.where(hit, pos_c, -1).astype(np.int32).reshape(shape)


def full_neighborhood_offsets(size: int, include_center: bool = False) -> np.ndarray:
    """All offsets in a (2·size+1)³ cube, z-major as the reference enumerates
    them (``algorithms.cpp:92-115``)."""
    r = np.arange(-size, size + 1)
    g = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1).reshape(-1, 3)
    if not include_center:
        g = g[np.any(g != 0, axis=1)]
    order = np.lexsort((g[:, 0], g[:, 1], g[:, 2]))
    return g[order].astype(np.int32)


# 6-neighborhood in the reference's order (+x, −x, +y, −y, +z, −z)
RING6_OFFSETS = np.array(
    [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]], dtype=np.int32
)

# forward-difference normal stencil: center, +x, +y, +z
NORMAL_OFFSETS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=np.int32)

# the 10-voxel SDF stencil of the shading cost, in the reference's parameter
# order (``shading_cost.cpp:87-110``)
EG_SDF_OFFSETS = np.array(
    [
        [0, 0, 0],
        [0, 1, 0],
        [0, 2, 0],
        [0, 1, 1],
        [0, 0, 1],
        [0, 0, 2],
        [1, 0, 0],
        [1, 1, 0],
        [1, 0, 1],
        [2, 0, 0],
    ],
    dtype=np.int32,
)

# the 4 albedo parameters of the shading cost: center, +x, +y, +z
EG_ALBEDO_OFFSETS = NORMAL_OFFSETS


@dataclasses.dataclass
class VoxelGrid:
    """Sorted voxel table with SoA fields (`VoxelSBR`,
    ``sparse_voxel_grid.h:69-77``): color is float32 RGB in [0, 255]."""

    voxel_size: float
    coords: np.ndarray  # [N, 3] int32, key-sorted
    keys: np.ndarray  # [N] int64, sorted
    sdf: np.ndarray  # [N] f32
    weight: np.ndarray  # [N] f32
    color: np.ndarray  # [N, 3] f32, 0..255
    albedo: Optional[np.ndarray] = None  # [N] f32
    sdf_refined: Optional[np.ndarray] = None  # [N] f32
    depth_min: float = 0.1
    depth_max: float = 10.0
    integration_weight_sample: float = 10.0

    @property
    def truncation(self) -> float:
        return self.voxel_size * 5.0

    @property
    def num_voxels(self) -> int:
        return int(self.coords.shape[0])

    @classmethod
    def from_coords(
        cls,
        voxel_size: float,
        coords: np.ndarray,
        depth_min: float = 0.1,
        depth_max: float = 10.0,
        sbr: bool = False,
    ) -> "VoxelGrid":
        coords = np.asarray(coords, dtype=np.int32).reshape(-1, 3)
        keys = pack_coords(coords)
        order = np.argsort(keys, kind="stable")
        keys = keys[order]
        coords = np.ascontiguousarray(coords[order])
        n = len(coords)
        g = cls(
            voxel_size=float(voxel_size),
            coords=coords,
            keys=keys,
            sdf=np.zeros(n, np.float32),
            weight=np.zeros(n, np.float32),
            color=np.zeros((n, 3), np.float32),
            depth_min=depth_min,
            depth_max=depth_max,
        )
        if sbr:
            g.albedo = np.full(n, 0.6, np.float32)
            g.sdf_refined = np.zeros(n, np.float32)
        return g

    @property
    def is_sbr(self) -> bool:
        return self.sdf_refined is not None

    def neighbor_table(self, offsets: np.ndarray) -> np.ndarray:
        """Gather-index table `[N, S]` for stencil offsets `[S, 3]`; −1 absent
        (native hash table)."""
        return native.neighbor_table(self.coords, np.asarray(offsets, np.int32))

    def lookup(self, coords: np.ndarray) -> np.ndarray:
        """Table indices of query coords `[..., 3]` (−1 where absent; native
        hash table)."""
        coords = np.asarray(coords, dtype=np.int64)
        return native.find_indices(self.coords, coords.reshape(-1, 3)).reshape(coords.shape[:-1])

    def exists(self, coords: np.ndarray) -> np.ndarray:
        return self.lookup(coords) >= 0

    def valid_mask(self) -> np.ndarray:
        """Per-voxel `weight > 0` (``sparse_voxel_grid.cpp:253-259``)."""
        return self.weight > 0.0

    def voxel_to_world(self, coords=None) -> np.ndarray:
        c = self.coords if coords is None else np.asarray(coords)
        return c.astype(np.float32) * np.float32(self.voxel_size)

    def world_to_voxel(self, pts: np.ndarray) -> np.ndarray:
        return np.round(np.asarray(pts) / self.voxel_size).astype(np.int32)

    def select(self, mask_or_indices) -> "VoxelGrid":
        """New grid containing the selected voxels (sorted order preserved)."""
        idx = (
            np.flatnonzero(mask_or_indices)
            if np.asarray(mask_or_indices).dtype == bool
            else np.asarray(mask_or_indices)
        )
        return VoxelGrid(
            voxel_size=self.voxel_size,
            coords=np.ascontiguousarray(self.coords[idx]),
            keys=self.keys[idx],
            sdf=self.sdf[idx].copy(),
            weight=self.weight[idx].copy(),
            color=self.color[idx].copy(),
            albedo=None if self.albedo is None else self.albedo[idx].copy(),
            sdf_refined=None if self.sdf_refined is None else self.sdf_refined[idx].copy(),
            depth_min=self.depth_min,
            depth_max=self.depth_max,
            integration_weight_sample=self.integration_weight_sample,
        )

    def to_sbr(self) -> "VoxelGrid":
        """Voxel → VoxelSBR conversion: `sdf_refined ← sdf`, albedo 0.6, and
        invalid (weight ≤ 0) voxels dropped (``algorithms.cpp:47-72``)."""
        g = self.select(self.valid_mask())
        g.albedo = np.full(g.num_voxels, 0.6, np.float32)
        g.sdf_refined = g.sdf.astype(np.float32).copy()
        return g

    def clone(self) -> "VoxelGrid":
        return self.select(np.arange(self.num_voxels))

    # -- serialization (.tsdf) --------------------------------------------

    def to_tsdf(self) -> TsdfVolume:
        return TsdfVolume(
            voxel_size=self.voxel_size,
            truncation=self.truncation,
            integration_weight_sample=self.integration_weight_sample,
            coords=self.coords,
            sdf=self.sdf.astype(np.float64 if self.is_sbr else np.float32),
            weight=self.weight,
            color=np.clip(self.color, 0, 255).astype(np.uint8),
            albedo=None if self.albedo is None else self.albedo.astype(np.float64),
            sdf_refined=None if self.sdf_refined is None else self.sdf_refined.astype(np.float64),
        )

    def save(self, filename: str) -> None:
        save_tsdf(filename, self.to_tsdf())

    @classmethod
    def load(cls, filename: str, depth_min: float = 0.1, depth_max: float = 10.0) -> "VoxelGrid":
        vol = load_tsdf(filename)
        g = cls.from_coords(vol.voxel_size, vol.coords, depth_min, depth_max, sbr=vol.is_sbr)
        # re-sort payload to match key order
        order = np.argsort(pack_coords(vol.coords.astype(np.int64)), kind="stable")
        g.sdf = vol.sdf[order].astype(np.float32)
        g.weight = vol.weight[order].astype(np.float32)
        g.color = vol.color[order].astype(np.float32)
        g.integration_weight_sample = vol.integration_weight_sample
        if vol.is_sbr:
            g.albedo = vol.albedo[order].astype(np.float32)
            g.sdf_refined = vol.sdf_refined[order].astype(np.float32)
        return g
