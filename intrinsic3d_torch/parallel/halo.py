"""Static halo-exchange plans for spatial block sharding.

A copy of the numpy-only `intrinsic3d_tpu/parallel/halo.py` (the port
imports nothing of the JAX package). The solver's voxel fields are
`[nb, B³]` block rows (refine/blockform.py). Under spatial sharding each
rank owns a contiguous BRICK of `m = nb / n` block rows; every stencil
shift (`grid.blocks.ShiftPlan`) reads neighbour block rows that may live on
another rank. The block topology is static per level, so the whole exchange
is precomputed on the host:

- traffic is grouped by mesh SHIFT δ = (dst − src) mod n, each active shift
  carrying exactly `Hs_δ` rows (block keys are spatially sorted, so a
  brick's stencil neighbours live almost entirely in the ±1 bricks: the
  volume is the brick's SURFACE, not its volume);
- ``send[δ] [n, Hs_δ]`` — the LOCAL row ids rank q ships to rank
  (q+δ) mod n (padded with `m`, q's all-zero pad row);
- ``nbr_local [n, D, m]`` — each rank's per-direction neighbour table,
  remapped into its EXTENDED field `concat([local m rows, δ-pools, pad])`.

The transpose (scatter-add of stencil cotangents) rides the same tables
backwards. `parallel.spmd.ShardedPlan` carries every shift of one exchange
in one all-to-all.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Host-built exchange tables for one (BlockLayout, mesh size) pair."""

    n: int  # devices
    m: int  # block rows per device
    shifts: Tuple[int, ...]  # active mesh shifts δ (1..n-1)
    hs: Tuple[int, ...]  # rows exchanged per active shift
    send: Tuple[np.ndarray, ...]  # per shift: [n, Hs_δ] int32 local rows (pad = m)
    # per-plan remapped neighbor tables into the extended field:
    # ext layout = [0, m) local | per-shift pools | pad row
    nbr_local: Tuple[np.ndarray, ...]  # per ShiftPlan: [n, D, m] int32

    @property
    def pool_rows(self) -> int:
        return int(sum(self.hs))

    @property
    def ext_rows(self) -> int:
        return self.m + self.pool_rows + 1

    @property
    def pad_row(self) -> int:
        return self.m + self.pool_rows


def build_halo_plan(num_blocks: int, n_devices: int, nbr_tables) -> HaloPlan:
    """Build the exchange plan.

    `nbr_tables` is a sequence of `[D_i, nb]` global neighbor-row tables (one
    per ShiftPlan; entries in [0, nb] with nb = the global pad row). The halo
    pools are shared across all tables (union of needed rows).
    """
    nb = num_blocks
    n = n_devices
    if nb % n != 0:
        raise ValueError(f"num_blocks {nb} not divisible by mesh size {n}")
    m = nb // n

    # rows needed per device (global ids, remote only)
    needed = []
    for p in range(n):
        rows = np.concatenate([t[:, p * m : (p + 1) * m].reshape(-1) for t in nbr_tables])
        rows = np.unique(rows)
        rows = rows[(rows != nb) & ((rows < p * m) | (rows >= (p + 1) * m))]
        needed.append(rows)

    # group by shift δ = (dst - src) mod n
    send_lists = {}  # δ -> [src q] -> local rows on q for dst (q+δ) % n
    for p in range(n):
        owners = needed[p] // m
        for q in np.unique(owners):
            delta = int((p - q) % n)
            rows_q = needed[p][owners == q] - q * m
            send_lists.setdefault(delta, [np.zeros(0, np.int64)] * n)[int(q)] = rows_q

    shifts = tuple(sorted(send_lists))
    hs = tuple(max(max((len(r) for r in send_lists[d]), default=0), 1) for d in shifts)
    send = []
    for d, h in zip(shifts, hs):
        tbl = np.full((n, h), m, np.int32)
        for q in range(n):
            rows = send_lists[d][q]
            tbl[q, : len(rows)] = rows
        send.append(tbl)

    # pool base offsets per shift in the ext layout
    base = {}
    off = m
    for d, h in zip(shifts, hs):
        base[d] = off
        off += h
    pad_row = off

    # per-device map: global row -> ext index
    nbr_local = []
    for t in nbr_tables:
        dct = t.shape[0]
        out = np.empty((n, dct, m), np.int32)
        for p in range(n):
            lookup = np.full(nb + 1, -1, np.int64)
            lookup[nb] = pad_row
            lookup[p * m : (p + 1) * m] = np.arange(m)
            for d, h in zip(shifts, hs):
                q = (p - d) % n  # the source whose shipment lands here
                rows = send_lists[d][q]
                lookup[rows + q * m] = base[d] + np.arange(len(rows))
            loc = lookup[t[:, p * m : (p + 1) * m]]
            if np.any(loc < 0):
                raise AssertionError("halo plan missed a needed row")
            out[p] = loc
        nbr_local.append(out)

    return HaloPlan(
        n=n,
        m=m,
        shifts=shifts,
        hs=hs,
        send=tuple(send),
        nbr_local=tuple(nbr_local),
    )
