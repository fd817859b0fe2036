"""Table-driven marching cubes (reference-parity surface extractor).

Re-design of ``libintrinsic3d/src/mesh/marching_cubes.cpp``: the reference uses
the classic Bourke edge/triangle tables (``marching_cubes.cpp:330-623``), a
per-cube case index over 8 corners requiring weight > 0 (``:250-276``), linear
zero-crossing interpolation of position and color along cube edges
(``:279-317``), and exact-position vertex merging (``:97-142``).

Rather than transcribing the 256x16 tables, they are **derived at import time**
by directed face-segment tracing:

- each cube face is a marching-squares problem; crossings on the face's
  boundary edges are paired *exit -> next entry* in the face's CCW-from-outside
  cycle order (a rule that is symmetric under face reversal, so two cubes
  sharing a face always cut it with the same undirected segments => the global
  surface is watertight and crack-free *by construction*, including on
  ambiguous faces where the classic tables can disagree);
- every crossing cube-edge is an exit in exactly one of its two faces and an
  entry in the other, so the directed segments chain into disjoint directed
  loops; each loop is fan-triangulated;
- the exit->entry direction keeps the inside (sdf < 0) region to the left of
  each segment when the face is viewed from outside the cube, which makes the
  loop orientation globally consistent; the fan winding is chosen so triangle
  normals point toward positive SDF (outward), matching the tet extractor.

Vertices lie only on cube edges (as in the reference), and merging is by
quantized position exactly like ``mesh/extract.py``.

Copy of `intrinsic3d_tpu/mesh/marching_cubes.py`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from intrinsic3d_torch.grid.voxel_grid import VoxelGrid

# corner id i -> offset (i & 1, (i >> 1) & 1, (i >> 2) & 1)
CORNER_OFFSETS = np.array(
    [[i & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], dtype=np.int64
)

# the 12 cube edges as (corner a, corner b), grouped by axis: edge id 4*axis+k
_AX_BIT = [1, 2, 4]
CUBE_EDGES = []
for axis in range(3):
    lows = [c for c in range(8) if not c & _AX_BIT[axis]]
    for a in lows:
        CUBE_EDGES.append((a, a | _AX_BIT[axis]))
CUBE_EDGES = np.array(CUBE_EDGES, dtype=np.int64)  # [12, 2]
# per-edge canonical key: (offset of low corner, axis)
EDGE_AXIS = np.repeat(np.arange(3), 4)
EDGE_BASE = CORNER_OFFSETS[CUBE_EDGES[:, 0]]  # [12, 3]

_EDGE_ID = {tuple(sorted(e)): i for i, e in enumerate(map(tuple, CUBE_EDGES))}


def _face_cycles():
    """6 faces as directed 4-corner cycles, CCW when viewed from outside."""
    faces = []
    for axis in range(3):
        for side in (0, 1):
            corners = [c for c in range(8) if ((c >> axis) & 1) == side]
            # order the 4 corners into a cycle in the face plane
            u_ax, v_ax = [a for a in range(3) if a != axis]
            pts = CORNER_OFFSETS[corners][:, [u_ax, v_ax]].astype(np.float64)
            ctr = pts.mean(axis=0)
            ang = np.arctan2(pts[:, 1] - ctr[1], pts[:, 0] - ctr[0])
            cyc = [corners[i] for i in np.argsort(ang)]
            # check winding: CCW around the outward normal (right-hand rule)
            n_out = np.zeros(3)
            n_out[axis] = 1.0 if side else -1.0
            p = CORNER_OFFSETS[cyc].astype(np.float64)
            cross = np.cross(p[1] - p[0], p[2] - p[1])
            if np.dot(cross, n_out) < 0:
                cyc = cyc[::-1]
            faces.append(cyc)
    return faces


_FACES = _face_cycles()


def _build_tables() -> Tuple[np.ndarray, np.ndarray]:
    """Derive (edge_table [256] uint16 crossing bitmask, tri_table [256,T,3]
    edge ids, -1 padded). Case bit i set <=> corner i inside (sdf < 0)."""
    all_tris = []
    edge_mask = np.zeros(256, dtype=np.uint16)
    max_tris = 0
    for case in range(256):
        inside = [(case >> i) & 1 for i in range(8)]
        # directed segments: next_edge[exit edge] = entry edge
        nxt = {}
        for cyc in _FACES:
            crossings = []  # (edge id, is_exit) in cycle order
            for k in range(4):
                a, b = cyc[k], cyc[(k + 1) % 4]
                if inside[a] != inside[b]:
                    crossings.append((_EDGE_ID[tuple(sorted((a, b)))], bool(inside[a])))
            # pair each exit with the next entry in cycle order
            for k, (e, is_exit) in enumerate(crossings):
                if not is_exit:
                    continue
                for j in range(1, len(crossings) + 1):
                    e2, is_exit2 = crossings[(k + j) % len(crossings)]
                    if not is_exit2:
                        nxt[e] = e2
                        break
        for e in nxt:
            edge_mask[case] |= 1 << e
        # trace directed loops and fan-triangulate
        tris = []
        seen = set()
        for start in sorted(nxt):
            if start in seen:
                continue
            loop = [start]
            seen.add(start)
            e = nxt[start]
            while e != start:
                loop.append(e)
                seen.add(e)
                e = nxt[e]
            for k in range(1, len(loop) - 1):
                tris.append((loop[0], loop[k], loop[k + 1]))
        max_tris = max(max_tris, len(tris))
        all_tris.append(tris)

    tri_table = -np.ones((256, max_tris, 3), dtype=np.int64)
    for case, tris in enumerate(all_tris):
        for t, tri in enumerate(tris):
            tri_table[case, t] = tri

    # fix global winding so normals point toward positive SDF: check the
    # single-inside-corner case (corner 0 inside; sdf<0 at origin) — the
    # surface normal must point away from corner 0
    case = 1
    tri = tri_table[case, 0]
    mids = 0.5 * (
        CORNER_OFFSETS[CUBE_EDGES[tri, 0]] + CORNER_OFFSETS[CUBE_EDGES[tri, 1]]
    ).astype(np.float64)
    n = np.cross(mids[1] - mids[0], mids[2] - mids[0])
    away = mids.mean(axis=0) - CORNER_OFFSETS[0]
    if np.dot(n, away) < 0:
        tri_table = tri_table[:, :, [0, 2, 1]]
    return edge_mask, tri_table


EDGE_TABLE, TRI_TABLE = _build_tables()


def extract_surface_mc(
    grid: VoxelGrid,
    sdf: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
    iso: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Extract the iso-surface with table-driven marching cubes.

    Same contract as ``mesh.extract.extract_surface``: returns
    (vertices [V,3] world f32, faces [F,3] int32, colors [V,3] u8).
    A cube participates only when all 8 corners exist with weight > 0
    (``marching_cubes.cpp:250-276``).
    """
    values = grid.sdf if sdf is None else sdf
    cols = grid.color if colors is None else colors
    values = np.asarray(values, np.float64) - iso

    corner_coords = grid.coords[:, None, :].astype(np.int64) + CORNER_OFFSETS[None, :, :]
    cidx = grid.lookup(corner_coords)  # [N, 8]
    ok = np.all((cidx >= 0) & (grid.weight[np.maximum(cidx, 0)] > 0.0), axis=-1)
    cidx = cidx[ok]  # [C, 8]
    empty = (
        np.zeros((0, 3), np.float32),
        np.zeros((0, 3), np.int32),
        np.zeros((0, 3), np.uint8),
    )
    if len(cidx) == 0:
        return empty

    vals8 = values[cidx]  # [C, 8]
    case = np.zeros(len(cidx), dtype=np.int64)
    for i in range(8):
        case |= (vals8[:, i] < 0).astype(np.int64) << i

    tris = TRI_TABLE[case]  # [C, T, 3] edge ids (-1 pad)
    cube_id, slot = np.nonzero(tris[:, :, 0] >= 0)
    if len(cube_id) == 0:
        return empty
    tri_edges = tris[cube_id, slot]  # [M, 3]

    base = grid.coords[ok].astype(np.float64)  # [C, 3] voxel coords
    cols8 = cols[cidx]  # [C, 8, 3]

    a = CUBE_EDGES[tri_edges, 0]  # [M, 3] corner ids
    b = CUBE_EDGES[tri_edges, 1]
    va = np.take_along_axis(vals8[cube_id], a, axis=1)
    vb = np.take_along_axis(vals8[cube_id], b, axis=1)
    t = va / np.where(va - vb == 0.0, 1e-30, va - vb)
    t = np.clip(t, 0.0, 1.0)  # [M, 3]
    pa = base[cube_id][:, None, :] + CORNER_OFFSETS[a]
    pb = base[cube_id][:, None, :] + CORNER_OFFSETS[b]
    pos = (pa + (pb - pa) * t[..., None]) * grid.voxel_size  # [M, 3, 3]
    ca = np.take_along_axis(cols8[cube_id], a[..., None], axis=1)
    cb = np.take_along_axis(cols8[cube_id], b[..., None], axis=1)
    col = ca + (cb - ca) * t[..., None]

    # merge vertices by quantized position (reference merges by exact position,
    # marching_cubes.cpp:97-142; edge-shared vertices are bitwise identical
    # here because both cubes interpolate the same two corner values)
    flat = pos.reshape(-1, 3)
    quant = np.round(flat / (grid.voxel_size * 1e-6)).astype(np.int64)
    uniq, inv = np.unique(quant, axis=0, return_inverse=True)
    first_idx = np.full(len(uniq), len(flat), np.int64)
    np.minimum.at(first_idx, inv, np.arange(len(flat)))
    vertices = flat[first_idx].astype(np.float32)
    vcolors = np.clip(col.reshape(-1, 3)[first_idx], 0, 255).astype(np.uint8)
    faces = inv.reshape(-1, 3).astype(np.int32)

    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return vertices, faces[good], vcolors
