"""The exported mesh against the grid it was extracted from
(marching_cubes.cpp:97-317): a marching-cubes vertex lies on each cube
edge whose two corners' SDF values have different signs (negative inside),
at the linear zero crossing, in every cube whose 8 corners are valid. The
reference works out those vertices from the grid and matches the mesh's
vertices to them edge by edge."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.common import CORNERS8, quantile


def read_ply_vertices(path: str) -> np.ndarray:
    """Vertex positions `[V, 3]` of a binary little-endian PLY whose vertex
    element holds float x, y, z and optionally uchar red, green, blue."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        if "format binary_little_endian 1.0" not in header:
            raise ValueError(f"{path}: not a binary little-endian PLY")
        nv = next(int(h.split()[2]) for h in header if h.startswith("element vertex"))
        stride = 12 + (3 if "property uchar red" in header else 0)
        raw = np.frombuffer(f.read(nv * stride), dtype=np.uint8).reshape(nv, stride)
    return raw[:, :12].copy().view("<f4").reshape(nv, 3)


def crossing_vertices(coords, sdf, weight, voxel: float, dtype):
    """(edge keys `[E]`, positions `[E, 3]`, key function) of the zero
    crossings on the edges of full cubes; an edge's key is its lower
    corner's index in the grid's box times 3 plus its axis."""
    dev = coords.device
    c = coords.to(torch.int64)
    lo = c.min(0).values - 1
    shape = (c.max(0).values - lo + 2).tolist()
    ci = c - lo
    val = torch.zeros(shape, dtype=torch.bool, device=dev)
    val[ci[:, 0], ci[:, 1], ci[:, 2]] = weight > 0
    s = torch.zeros(shape, dtype=dtype, device=dev)
    s[ci[:, 0], ci[:, 1], ci[:, 2]] = sdf.to(dtype)
    nx, ny, nz = shape

    def edge_key(local, axis):
        inside = ((local >= 0) & (local < torch.tensor(shape, device=dev))).all(-1)
        k = ((local[..., 0] * ny + local[..., 1]) * nz + local[..., 2]) * 3 + axis
        return torch.where(inside, k, torch.full_like(k, -1))

    full = torch.ones((nx - 1, ny - 1, nz - 1), dtype=torch.bool, device=dev)
    for o in CORNERS8:
        full &= val[o[0]:nx - 1 + o[0], o[1]:ny - 1 + o[1], o[2]:nz - 1 + o[2]]
    keys, pos = [], []
    for axis in range(3):
        # the cubes that share an edge of this axis from its lower corner
        act = torch.zeros(shape, dtype=torch.bool, device=dev)
        others = [a for a in range(3) if a != axis]
        for d1 in (0, 1):
            for d2 in (0, 1):
                sh = [0, 0, 0]
                sh[others[0]], sh[others[1]] = d1, d2
                act[sh[0]:sh[0] + nx - 1, sh[1]:sh[1] + ny - 1, sh[2]:sh[2] + nz - 1] |= full
        e = [0, 0, 0]
        e[axis] = 1
        a_val = s[:nx - e[0], :ny - e[1], :nz - e[2]]
        b_val = s[e[0]:, e[1]:, e[2]:]
        act = act[:nx - e[0], :ny - e[1], :nz - e[2]]
        cross = act & ((a_val < 0) != (b_val < 0))
        idx = torch.nonzero(cross)
        va, vb = a_val[cross], b_val[cross]
        den = torch.where(va - vb == 0, torch.full_like(va, 1e-30), va - vb)
        t = torch.clamp(va / den, 0.0, 1.0)
        p = (idx + lo).to(dtype)
        p[:, axis] = p[:, axis] + t
        pos.append(p * voxel)
        keys.append(edge_key(idx, axis))
    return torch.cat(keys), torch.cat(pos), lambda corner, axis: edge_key(corner - lo, axis)


def compare_mesh(vertices: np.ndarray, coords, sdf, weight, voxel: float, dtype=torch.float64) -> dict:
    """Readings of a mesh's vertices `[V, 3]` against the crossings of its
    grid: the 99th percentile of each vertex's distance (in voxels) to the
    crossing on its edge (1 where it lies on no crossing edge), and the
    share of crossings with no vertex."""
    dev = coords.device
    keys, ref, key_of = crossing_vertices(coords, sdf, weight, voxel, dtype)
    order = torch.argsort(keys)
    keys, ref = keys[order], ref[order]
    v = torch.as_tensor(vertices, device=dev).to(torch.float64) / voxel
    frac = torch.abs(v - torch.round(v))
    axis = torch.argmax(frac, dim=1)
    base = torch.round(v)
    base[torch.arange(v.shape[0], device=dev), axis] = torch.floor(v[torch.arange(v.shape[0], device=dev), axis])
    q = key_of(base.to(torch.int64), axis)
    pos = torch.searchsorted(keys, q).clamp(max=max(keys.numel() - 1, 0))
    hit = keys[pos] == q if keys.numel() else torch.zeros_like(q, dtype=torch.bool)
    gap = torch.where(hit, torch.linalg.vector_norm(v - ref[pos].to(torch.float64) / voxel, dim=1),
                      torch.ones(v.shape[0], dtype=torch.float64, device=dev))
    covered = torch.zeros(keys.numel(), dtype=torch.bool, device=dev)
    covered[pos[hit]] = True
    return {"mesh_vertex_gap": quantile(gap, 0.99),
            "mesh_missing_share": 1.0 - float(covered.sum()) / max(keys.numel(), 1)}
