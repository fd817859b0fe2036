"""Per-rank placement of sharded fields, and their gather back.

Counterpart of `intrinsic3d_tpu/parallel/staging.py`. Each rank builds only
its own index range along the sharded dimension, on its own device; nothing
is built for another rank. A field of global length `L` along the sharded
dimension is split into `size` equal contiguous ranges (`L` must divide):

- `stage_rows(mesh, shape, dtype, build_rows, shard_dim)` — this rank's
  range `[lo, hi)` built by the `build_rows(lo, hi)` callback;
- `stage_sliced(mesh, array)` — this rank's rows of a host array every
  rank holds;
- `stage_replicated(mesh, array)` — the whole value on this rank's device;
- `stage_table_rows(mesh, layout, vals, …)` — a voxel-table field
  `[N(, C…)]` scattered into this rank's block rows `[m, B³(, C…)]`;
- `to_global(mesh, local, dim)` — the inverse: every rank's range
  all-gathered into the full tensor on every rank (the JAX package's
  `to_host_global`, which reads a sharded array back to the host).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from intrinsic3d_torch.parallel.sharding import Mesh


def row_range(mesh: Mesh, total: int) -> Tuple[int, int]:
    """This rank's `[lo, hi)` of `total` rows split evenly over the ranks."""
    if total % mesh.size != 0:
        raise ValueError(f"{total} rows do not divide over {mesh.size} ranks")
    m = total // mesh.size
    return mesh.rank * m, (mesh.rank + 1) * m


def stage_rows(
    mesh: Mesh,
    shape: Sequence[int],
    dtype,
    build_rows: Callable[[int, int], np.ndarray],
    shard_dim: int = 0,
) -> torch.Tensor:
    """This rank's range of a field of global `shape`, built by
    `build_rows(lo, hi)` (the global rows `[lo:hi)` along `shard_dim`, every
    other dimension full) and placed on the rank's device."""
    shape = tuple(int(v) for v in shape)
    lo, hi = row_range(mesh, shape[shard_dim])
    rows = np.ascontiguousarray(np.asarray(build_rows(lo, hi), dtype))
    want = shape[:shard_dim] + (hi - lo,) + shape[shard_dim + 1 :]
    if rows.shape != want:
        raise ValueError(f"build_rows({lo}, {hi}) returned {rows.shape}, expected {want}")
    return torch.as_tensor(rows, device=mesh.device)


def stage_sliced(mesh: Mesh, array) -> torch.Tensor:
    """`stage_rows` for a host array every rank holds in full: this rank's
    rows along the first dimension."""
    arr = np.asarray(array)
    return stage_rows(mesh, arr.shape, arr.dtype, lambda lo, hi: arr[lo:hi])


def stage_replicated(mesh: Mesh, array) -> torch.Tensor:
    """The whole host value on this rank's device (every rank passes the
    same value)."""
    return torch.as_tensor(np.array(array), device=mesh.device)


def stage_table_rows(
    mesh: Mesh,
    layout,
    vals,
    dtype=np.float32,
    fill=0.0,
    trailing: Sequence[int] = (),
) -> torch.Tensor:
    """A voxel-table field `[N(, C…)]` in this rank's block rows
    `[m, B³(, C…)]` (the `layout.vox_slot` scatter), empty slots `fill`."""
    s = layout.block**3
    slot = layout.vox_slot
    vals = np.asarray(vals)

    def build(lo, hi):
        out = np.full(((hi - lo) * s,) + tuple(trailing), fill, dtype)
        sel = (slot >= lo * s) & (slot < hi * s)
        out[slot[sel] - lo * s] = vals[sel].astype(dtype)
        return out.reshape((hi - lo, s) + tuple(trailing))

    return stage_rows(mesh, (layout.num_blocks, s) + tuple(trailing), dtype, build)


def to_global(mesh: Mesh, local: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's equal-sized range of a field, all-gathered along `dim`
    into the global tensor, on every rank."""
    return mesh.all_gather_cat(local, dim)
