"""Block-dense voxel layout and stencil shift plans.

Counterpart of the flat `[nb, B³]` part of `intrinsic3d_tpu/grid/blocks.py`.
Voxels are partitioned into B³ blocks (one block = one row of B³ lanes) and
every per-voxel field lives as `[nb+1, B³]` with a trailing all-zero pad row
that absent neighbours point at.

A stencil offset o maps each destination lane of block n to one lane of one
neighbouring block (the block-corner direction the shifted cell falls in).
The JAX package realizes this as block-row gathers plus `[B³, k·B³]` one-hot
matmuls on the TPU's matrix unit. Here `ShiftPlan` keeps two index tables
instead: the neighbour block row per direction (`nbr [D, nb]`), and per
offset the source lane in the direction-major row stack (`lane_src [T, B³]`,
values `d·B³ + lane`). `apply` is then one block-row gather plus one lane
gather, and `apply_transpose` a lane scatter per offset plus one `index_add_`
over block rows per direction.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from intrinsic3d_torch.device import resolve_device
from intrinsic3d_torch.grid.voxel_grid import VoxelGrid, pack_coords, unpack_keys


@dataclasses.dataclass
class BlockLayout:
    """Mapping between a sorted voxel table and dense B³ blocks."""

    block: int  # B, block edge length
    block_coords: np.ndarray  # [nb, 3] block grid coords
    vox_slot: np.ndarray  # [N] flat index into [nb * B³] for each table voxel
    nbr27: np.ndarray  # [nb, 27] neighbour block row per 3³ direction; nb = absent

    @property
    def num_blocks(self) -> int:
        return len(self.block_coords)

    @classmethod
    def build(cls, grid: VoxelGrid, block: int = 8, blocks_multiple: int = 8) -> "BlockLayout":
        """Partition the grid's voxels into blocks. `blocks_multiple` pads the
        block count with empty, mutually non-adjacent blocks beyond the grid's
        corner, exactly as the JAX layout does (same nb, same block order)."""
        B = block
        coords = grid.coords.astype(np.int64)
        bc = np.floor_divide(coords, B)
        bkeys = pack_coords(bc)
        ukeys = np.unique(bkeys)
        need = (-len(ukeys)) % max(blocks_multiple, 1)
        if need:
            mx = bc.max(axis=0)
            pads = np.stack(
                [
                    mx[0] + 2 + 2 * np.arange(need),
                    np.full(need, mx[1] + 2),
                    np.full(need, mx[2] + 2),
                ],
                axis=-1,
            )
            ukeys = np.sort(np.concatenate([ukeys, pack_coords(pads)]))
        binv = np.searchsorted(ukeys, bkeys)
        nb = len(ukeys)
        block_coords = unpack_keys(ukeys)

        lc = coords - bc * B  # [N,3] in [0,B)
        slot = (lc[:, 0] * B + lc[:, 1]) * B + lc[:, 2]
        vox_slot = (binv * (B**3) + slot).astype(np.int64)

        # 27-direction block adjacency: neighbour row, or nb (the pad row)
        d = np.arange(-1, 2)
        ddx, ddy, ddz = np.meshgrid(d, d, d, indexing="ij")
        dirs = np.stack([ddx, ddy, ddz], axis=-1).reshape(-1, 3)  # [27, 3]
        nbr_keys = pack_coords((block_coords[:, None, :] + dirs[None, :, :]).reshape(-1, 3))
        npos = np.searchsorted(ukeys, nbr_keys)
        npos_c = np.clip(npos, 0, nb - 1)
        nhit = (npos < nb) & (ukeys[npos_c] == nbr_keys)
        nbr27 = np.where(nhit, npos_c, nb).reshape(nb, 27).astype(np.int32)

        return cls(block=B, block_coords=block_coords, vox_slot=vox_slot, nbr27=nbr27)

    def slots_of(self, coords: np.ndarray) -> np.ndarray:
        """Flat slot index into `[nb * B³]` (int64) for voxel coords
        `[..., 3]`, −1 where the owning block is not in the layout."""
        B = self.block
        shape = coords.shape[:-1]
        c = np.asarray(coords, np.int64).reshape(-1, 3)
        bc = np.floor_divide(c, B)
        keys = pack_coords(bc)
        block_keys = pack_coords(self.block_coords)  # sorted: the build's order
        pos = np.searchsorted(block_keys, keys)
        pos_c = np.clip(pos, 0, self.num_blocks - 1)
        hit = (pos < self.num_blocks) & (block_keys[pos_c] == keys)
        lc = c - bc * B
        slot = (lc[:, 0] * B + lc[:, 1]) * B + lc[:, 2]
        out = np.where(hit, pos_c * (B**3) + slot, -1)
        return out.reshape(shape).astype(np.int64)


@dataclasses.dataclass
class ShiftPlan:
    """Static plan applying stencil offsets to `[nb+1, B³]` fields."""

    offsets: np.ndarray  # [T, 3]
    dir_vecs: np.ndarray  # [D, 3] block-corner directions used
    nbr: torch.Tensor  # [D, nb] int64 neighbour block row per direction (nb = pad row)
    lane_src: torch.Tensor  # [T, B³] int64 source lane in the [D·B³] row stack
    block: int

    def apply(self, field_pad: torch.Tensor) -> torch.Tensor:
        """`[nb+1, B³]` → `[T, nb, B³]` shifted fields (absent neighbours 0)."""
        s = self.block**3
        nb = field_pad.shape[0] - 1
        t = len(self.offsets)
        stack = field_pad[self.nbr.T].reshape(nb, -1)  # [nb, D·B³] block-row gather
        out = stack[:, self.lane_src.reshape(-1)]  # lane gather → [nb, T·B³]
        return out.reshape(nb, t, s).transpose(0, 1)

    def apply_transpose(self, cot: torch.Tensor) -> torch.Tensor:
        """Exact adjoint of `apply`: `[T, nb, B³]` cotangents → `[nb+1, B³]`.

        Each offset's lane map is injective, and so is each direction's row
        map apart from the pad row (the sink of absent neighbours, never read
        downstream), so every sum below has a fixed order on the card."""
        t, nb, s = cot.shape
        stack = cot.new_zeros(nb, len(self.dir_vecs) * s)
        for i in range(t):
            stack.index_add_(1, self.lane_src[i], cot[i])
        rows = stack.view(nb, len(self.dir_vecs), s)
        out = cot.new_zeros(nb + 1, s)
        for d in range(len(self.dir_vecs)):
            out.index_add_(0, self.nbr[d], rows[:, d])
        return out

    def index(self, offset) -> int:
        o = np.asarray(offset)
        hit = np.flatnonzero(np.all(self.offsets == o, axis=-1))
        if len(hit) != 1:
            raise KeyError(f"offset {tuple(o)} not in plan")
        return int(hit[0])


def build_shift_plan(layout: BlockLayout, offsets, device="cuda") -> ShiftPlan:
    """Precompute the gather decomposition of `offsets` on `layout`, its
    index tables on `device`."""
    dev = resolve_device(device)
    B = layout.block
    s = B**3
    offsets = np.asarray(offsets, np.int64).reshape(-1, 3)
    r = np.arange(B)
    gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
    cells = np.stack([gx, gy, gz], -1).reshape(-1, 3)  # [B³,3] flat-order locals

    corner, src = [], []
    for o in offsets:
        tgt = cells + o
        c = np.floor_divide(tgt, B)  # block-corner direction per destination lane
        lt = tgt - c * B
        corner.append(c)
        src.append((lt[:, 0] * B + lt[:, 1]) * B + lt[:, 2])
    dir_vecs = np.unique(np.concatenate(corner), axis=0)  # [D, 3], sorted
    dir_id = {tuple(v): i for i, v in enumerate(dir_vecs.tolist())}
    lane_src = np.stack(
        [
            np.array([dir_id[tuple(v)] for v in c.tolist()]) * s + sl
            for c, sl in zip(corner, src)
        ]
    )
    d27 = (dir_vecs[:, 0] + 1) * 9 + (dir_vecs[:, 1] + 1) * 3 + (dir_vecs[:, 2] + 1)
    nbr = layout.nbr27[:, d27].T  # [D, nb]
    return ShiftPlan(
        offsets=offsets,
        dir_vecs=dir_vecs,
        nbr=torch.as_tensor(np.ascontiguousarray(nbr), dtype=torch.int64, device=dev),
        lane_src=torch.as_tensor(lane_src, dtype=torch.int64, device=dev),
        block=B,
    )


def pad_flat(field: torch.Tensor) -> torch.Tensor:
    """Append the all-zero pad row: `[nb, B³] → [nb+1, B³]`."""
    return torch.cat([field, torch.zeros_like(field[:1])], dim=0)
