"""Mesh geometric-error metrics: point-to-mesh distance and chamfer distance.

The BASELINE bar for refinement quality is "reference-equivalent mesh within a
geometric-error bound" (BASELINE.md north stars); the reference itself ships no
metric tooling (its authors eyeballed PLYs — SURVEY §4). This module provides
the measurement: exact point-to-triangle distances accelerated by a k-d tree
over triangle centroids, area-weighted surface sampling, and the symmetric
chamfer distance between two meshes. Host-side numpy/scipy (output-side path,
not perf-critical).

Copy of `intrinsic3d_tpu/mesh/metrics.py`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
from scipy.spatial import cKDTree


def triangle_areas(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    p = verts[faces]  # [F, 3, 3]
    return 0.5 * np.linalg.norm(
        np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=-1
    )


def sample_surface(
    verts: np.ndarray,
    faces: np.ndarray,
    n: int,
    seed: int = 0,
) -> np.ndarray:
    """Area-weighted uniform random samples on the mesh surface `[n, 3]`."""
    areas = triangle_areas(verts, faces)
    total = areas.sum()
    if total <= 0 or len(faces) == 0:
        return np.zeros((0, 3), np.float64)
    rng = np.random.default_rng(seed)
    fi = rng.choice(len(faces), size=n, p=areas / total)
    u = rng.random(n)
    v = rng.random(n)
    flip = u + v > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    p = verts[faces[fi]].astype(np.float64)
    return p[:, 0] + u[:, None] * (p[:, 1] - p[:, 0]) + v[:, None] * (p[:, 2] - p[:, 0])


def _point_triangle_distance(points: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Exact distance from points[i] to triangle tris[i] (paired, [N])."""
    p0, p1, p2 = tris[:, 0], tris[:, 1], tris[:, 2]
    n = np.cross(p1 - p0, p2 - p0)
    nn = np.einsum("ij,ij->i", n, n)
    d0 = points - p0

    # projection onto the triangle plane + barycentric inside test
    dist_plane = np.abs(np.einsum("ij,ij->i", n, d0)) / np.sqrt(np.maximum(nn, 1e-300))
    q = points - n * (np.einsum("ij,ij->i", n, d0) / np.maximum(nn, 1e-300))[:, None]
    # barycentrics of q via signed sub-areas
    w0 = np.einsum("ij,ij->i", np.cross(p1 - q, p2 - q), n)
    w1 = np.einsum("ij,ij->i", np.cross(p2 - q, p0 - q), n)
    w2 = np.einsum("ij,ij->i", np.cross(p0 - q, p1 - q), n)
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (nn > 1e-300)

    def seg_dist(a, b):
        ab = b - a
        t = np.einsum("ij,ij->i", points - a, ab) / np.maximum(
            np.einsum("ij,ij->i", ab, ab), 1e-300
        )
        t = np.clip(t, 0.0, 1.0)
        return np.linalg.norm(points - (a + t[:, None] * ab), axis=-1)

    dist_edge = np.minimum(
        seg_dist(p0, p1), np.minimum(seg_dist(p1, p2), seg_dist(p2, p0))
    )
    return np.where(inside, dist_plane, dist_edge)


def point_to_mesh_distance(
    points: np.ndarray,
    verts: np.ndarray,
    faces: np.ndarray,
    k: int = 24,
    chunk: int = 65536,
) -> np.ndarray:
    """Distance from each point to the mesh surface `[N]`.

    Candidate triangles come from a k-d tree over triangle centroids (the k
    nearest centroids per point, k inflated by the largest triangle
    circumradius bound); exact point-to-triangle distance over candidates.
    """
    points = np.asarray(points, np.float64).reshape(-1, 3)
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces)
    if len(faces) == 0 or len(points) == 0:
        return np.full(len(points), np.inf)
    tri = verts[faces]  # [F, 3, 3]
    centroids = tri.mean(axis=1)
    # max distance from a centroid to its triangle's far point — guarantees
    # that the true closest triangle's centroid lies within d_k + 2*rmax, so
    # k nearest centroids suffice when triangles are of comparable size; we
    # simply use k candidates (regression-metric accuracy, not CAD-exact).
    tree = cKDTree(centroids)
    k = min(k, len(faces))
    out = np.empty(len(points))
    for s in range(0, len(points), chunk):
        pts = points[s : s + chunk]
        _, idx = tree.query(pts, k=k)
        idx = idx.reshape(len(pts), -1)  # [n, k]
        d = _point_triangle_distance(
            np.repeat(pts, idx.shape[1], axis=0), tri[idx.reshape(-1)]
        ).reshape(len(pts), -1)
        out[s : s + chunk] = d.min(axis=1)
    return out


def chamfer_distance(
    verts_a: np.ndarray,
    faces_a: np.ndarray,
    verts_b: np.ndarray,
    faces_b: np.ndarray,
    num_samples: int = 50000,
    seed: int = 0,
) -> dict:
    """Symmetric chamfer distance between two meshes.

    Returns dict with mean/rms/max of A→B and B→A sample distances plus the
    symmetric mean (the headline regression number).
    """
    pa = sample_surface(verts_a, faces_a, num_samples, seed)
    pb = sample_surface(verts_b, faces_b, num_samples, seed + 1)
    da = point_to_mesh_distance(pa, verts_b, faces_b)
    db = point_to_mesh_distance(pb, verts_a, faces_a)

    def stats(d):
        if len(d) == 0:
            return {"mean": np.inf, "rms": np.inf, "max": np.inf}
        return {
            "mean": float(d.mean()),
            "rms": float(np.sqrt((d**2).mean())),
            "max": float(d.max()),
        }

    return {
        "a_to_b": stats(da),
        "b_to_a": stats(db),
        "symmetric_mean": float(0.5 * (da.mean() + db.mean()))
        if len(da) and len(db)
        else np.inf,
    }


def mesh_error_vs_analytic(
    verts: np.ndarray,
    faces: np.ndarray,
    sdf_fn: Callable[[np.ndarray], np.ndarray],
    num_samples: int = 50000,
    seed: int = 0,
) -> dict:
    """Geometric error of a mesh against an analytic SDF ground truth:
    |sdf(x)| of area-weighted surface samples (exact for a true distance
    function near its zero set)."""
    pts = sample_surface(verts, faces, num_samples, seed)
    d = np.abs(np.asarray(sdf_fn(pts), np.float64))
    return {
        "mean": float(d.mean()),
        "rms": float(np.sqrt((d**2).mean())),
        "max": float(d.max()),
        "p95": float(np.percentile(d, 95)),
    }
