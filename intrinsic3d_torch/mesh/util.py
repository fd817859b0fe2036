"""Mesh post-processing: component filtering, vertex/face cleanup.

Equivalent of ``nv::MeshUtil`` (``libintrinsic3d/src/mesh/util.cpp``): the
reference builds a Boost.Graph over position-deduplicated vertices and keeps the
largest connected component; here the same is one scipy.sparse
`connected_components` call over the face adjacency.

Copy of `intrinsic3d_tpu/mesh/util.py`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import connected_components


def remove_degenerate_faces(faces: np.ndarray, vertices: np.ndarray) -> np.ndarray:
    """Drop faces with repeated indices or (numerically) zero area
    (``util.cpp:174-200``)."""
    faces = np.asarray(faces)
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    v = np.asarray(vertices)
    e1 = v[faces[:, 1]] - v[faces[:, 0]]
    e2 = v[faces[:, 2]] - v[faces[:, 0]]
    area2 = np.linalg.norm(np.cross(e1, e2), axis=-1)
    return faces[good & (area2 > 0.0)]


def remove_unused_vertices(
    vertices: np.ndarray, faces: np.ndarray, colors: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Reindex so only referenced vertices remain (``util.cpp:104-171``)."""
    used = np.zeros(len(vertices), bool)
    used[faces.reshape(-1)] = True
    remap = -np.ones(len(vertices), np.int64)
    remap[used] = np.arange(used.sum())
    new_faces = remap[faces].astype(np.int32)
    new_colors = None if colors is None else colors[used]
    return vertices[used], new_faces, new_colors


def remove_loose_components(
    vertices: np.ndarray, faces: np.ndarray, colors: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Keep only the largest connected component (``util.cpp:47-101``).

    Vertices at identical positions are collapsed for connectivity (the
    reference does the same), so components touching at a point merge.
    """
    if len(faces) == 0:
        return vertices, faces, colors
    # collapse duplicate positions for the connectivity graph
    quant = np.round(np.asarray(vertices, np.float64) * 1e7).astype(np.int64)
    _, group = np.unique(quant, axis=0, return_inverse=True)
    gf = group[faces]

    n = group.max() + 1
    rows = np.concatenate([gf[:, 0], gf[:, 1], gf[:, 2]])
    cols = np.concatenate([gf[:, 1], gf[:, 2], gf[:, 0]])
    adj = sp.coo_matrix((np.ones(len(rows), np.int8), (rows, cols)), shape=(n, n))
    ncomp, labels = connected_components(adj, directed=False)
    if ncomp <= 1:
        return vertices, faces, colors
    largest = np.bincount(labels, minlength=ncomp).argmax()
    keep_face = labels[gf[:, 0]] == largest
    faces = faces[keep_face]
    return remove_unused_vertices(vertices, faces, colors)
