"""A block level's statics built from its layout: CUDA kernel and plain version.

The function of `refine.device_assembly.level_static_host` followed by
`fill_voxel_sh`, computed slot by slot from the block layout alone, with no
stencil table: slot `s` of block `b` holds voxel `slot2vox[s]` (−1 empty),
and its +axis neighbour's slot is the next lane inside the block or lane 0
of the block row `nbr27[b, dir]` (`nb`: absent). Per slot the occupancy,
the validity (weight > 0), the voxel's coordinates, its sdf anchor and its
per-voxel SH, and per axis the chromaticity weight of the albedo pair with
its + neighbour (`refine.assembly.chroma_weights`, numpy's float32 order);
`occ` and `valid` carry the zero pad row. Every operation rounds once in
float32, as numpy's do.

On CUDA tensors `level_static` runs `csrc/level_static.cu` (built by
`ops.build`: a memset and two launches, counted once in
`build.LAUNCHES["level_static"]`), or raises; `level_static_plain` is the
same algorithm in numpy, which the CPU tests hold bitwise to the host
build.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from intrinsic3d_torch.ops import build

# nbr27's direction index of +x, +y, +z: (dx + 1) * 9 + (dy + 1) * 3 + (dz + 1)
PLUS_DIRS = (22, 16, 14)

_VP = ctypes.c_void_p
_SIGNATURE = [_VP] * 7 + [ctypes.c_int] * 3 + [_VP] * 8

# (name, dtype, shape from n voxels and nb blocks) of the kernel's inputs
_INPUTS = (
    ("vox_slot", torch.int64, lambda n, nb: (n,)),
    ("nbr27", torch.int32, lambda n, nb: (nb, 27)),
    ("block_coords", torch.int64, lambda n, nb: (nb, 3)),
    ("sdf", torch.float32, lambda n, nb: (n,)),
    ("weight", torch.float32, lambda n, nb: (n,)),
    ("color", torch.float32, lambda n, nb: (n, 3)),
    ("sh", torch.float32, lambda n, nb: (n, 9)),
)


def inputs_of(layout, grid, voxel_sh) -> Tuple[np.ndarray, ...]:
    """The kernel's seven inputs, in `_INPUTS`' order and dtypes, from a
    `BlockLayout`, its `VoxelGrid` and the per-voxel SH `[N, 9]`, as
    contiguous numpy arrays (copies only where a dtype differs)."""
    arrays = (layout.vox_slot, layout.nbr27, layout.block_coords, grid.sdf, grid.weight, grid.color, voxel_sh)
    dtypes = (np.int64, np.int32, np.int64, np.float32, np.float32, np.float32, np.float32)
    return tuple(np.ascontiguousarray(a, dt) for a, dt in zip(arrays, dtypes))


def _check(tensors: Tuple[torch.Tensor, ...], block: int) -> Tuple[int, int]:
    """(voxels, blocks) after checking the kernel's layouts: contiguous
    tensors of `_INPUTS`' dtypes and shapes on one CUDA device, and a slot
    count within int32."""
    if len(tensors) != len(_INPUTS):
        raise ValueError(f"the kernel takes {len(_INPUTS)} tensors, not {len(tensors)}")
    n, nb = tensors[0].shape[0], tensors[1].shape[0]
    for (name, dtype, shape), t in zip(_INPUTS, tensors):
        if t.dtype != dtype or tuple(t.shape) != shape(n, nb):
            raise ValueError(f"{name} must be a {dtype} {shape(n, nb)} tensor, not {t.dtype} {tuple(t.shape)}")
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"the kernel takes tensors on one CUDA device, not {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{[name for name, _, _ in _INPUTS]} must be contiguous")
    if not 1 <= block <= 64 or (nb + 1) * block**3 > 2**31 - 1 or n > nb * block**3:
        raise ValueError(f"{n} voxels in {nb} blocks of {block}^3 slots: beyond the kernel's int32 slots")
    return n, nb


def level_static(vox_slot, nbr27, block_coords, sdf, weight, color, sh, block: int):
    """`(occ, valid, vpos, es_ref, eg_sh, ea_chroma)` in `LevelStatic`'s
    shapes, built by the kernel on the current stream from a block layout
    (`vox_slot`, `nbr27`, `block_coords`: a `BlockLayout`'s, whose slots are
    distinct and in range) and the voxels' fields (counted once in
    `build.LAUNCHES["level_static"]`). Takes CUDA tensors only (`_check`);
    `level_static_plain` is the same function in numpy."""
    args = (vox_slot, nbr27, block_coords, sdf, weight, color, sh)
    n, nb = _check(args, block)
    s = block**3
    dev = vox_slot.device
    f32 = dict(dtype=torch.float32, device=dev)
    occ, valid = torch.empty((nb + 1, s), **f32), torch.empty((nb + 1, s), **f32)
    vpos = torch.empty((3, nb * s), dtype=torch.int32, device=dev)
    es_ref, eg_sh = torch.empty((nb, s), **f32), torch.empty((9, nb * s), **f32)
    ea_chroma = torch.empty((3, nb, s), **f32)
    slot2vox = torch.empty(nb * s, dtype=torch.int32, device=dev)
    fn = build.load("level_static").i3d_level_static
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(*(t.data_ptr() for t in args), n, nb, block,
                *(t.data_ptr() for t in (slot2vox, occ, valid, vpos, es_ref, eg_sh, ea_chroma)),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"level_static kernel launch failed for {n} voxels in {nb} blocks: CUDA error {rc}")
    build.LAUNCHES["level_static"] += 1
    return occ, valid, vpos, es_ref, eg_sh, ea_chroma


def level_static_plain(vox_slot, nbr27, block_coords, sdf, weight, color, sh, block: int):
    """The kernel's algorithm in numpy, slot by slot and operation for
    operation (each float32 product, sum, quotient and root one rounding),
    on the same inputs as numpy arrays; returns the same six arrays."""
    f32 = np.float32
    nb, s = len(nbr27), block**3
    d = nb * s
    slot2vox = np.full(d, -1, np.int64)
    slot2vox[vox_slot] = np.arange(len(vox_slot))
    slot = np.arange(d)
    b, lane = slot // s, slot % s
    lanes = np.stack([lane // (block * block), lane // block % block, lane % block])  # [3, D]
    here = slot2vox >= 0
    v = np.maximum(slot2vox, 0)

    def pad(field):
        return np.concatenate([field.reshape(nb, s), np.zeros((1, s), f32)])

    with np.errstate(all="ignore"):
        c01 = color / f32(255.0)
        luma = (f32(0.299) * color[:, 0] + f32(0.587) * color[:, 1]) + f32(0.114) * color[:, 2]
        luma = np.where(luma == f32(0.0), f32(1e-12), luma)
        chroma = c01 / luma[:, None]
        ea_chroma = np.zeros((3, d), f32)
        for a, (dir_, stride) in enumerate(zip(PLUS_DIRS, (block * block, block, 1))):
            nbb = nbr27[b, dir_].astype(np.int64)
            across = np.where(nbb < nb, nbb * s + lane - (block - 1) * stride, -1)
            t = np.where(lanes[a] == block - 1, across, slot + stride)
            u = np.where(t >= 0, slot2vox[np.maximum(t, 0)], -1)
            diff = chroma[v] - chroma[np.maximum(u, 0)]
            dist = np.sqrt((diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) + diff[:, 2] * diff[:, 2])
            w = np.maximum(f32(1.0) - dist, f32(0.01))
            ea_chroma[a] = np.where(here & (u >= 0) & np.isfinite(w), w, f32(0.0))
    occ = here.astype(f32)
    valid = (here & (weight[v] > 0.0)).astype(f32)
    vpos = np.where(here, block_coords[b].T * block + lanes, 0).astype(np.int32)
    es_ref = np.where(here, sdf[v], f32(0.0)).astype(f32)
    eg_sh = np.where(here, np.asarray(sh, f32)[v].T, f32(0.0)).astype(f32)
    out = (pad(occ), pad(valid), vpos, es_ref.reshape(nb, s), eg_sh, ea_chroma.reshape(3, nb, s))
    return tuple(np.ascontiguousarray(a) for a in out)  # the kernel's layouts
