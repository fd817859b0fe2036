"""Binary little-endian PLY mesh writer/reader.

Writer matches the reference's output byte-for-byte
(``libintrinsic3d/src/mesh.cpp:41-100``): float32 xyz (+optional uchar rgb)
vertices, uchar-count int32-index triangle faces. The reader exists for tests
and mesh-comparison tooling.

Copy of `intrinsic3d_tpu/io/ply.py`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def save_ply(
    filename: str,
    vertices: np.ndarray,
    faces: np.ndarray,
    colors: Optional[np.ndarray] = None,
) -> None:
    vertices = np.asarray(vertices, dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int32)
    has_colors = colors is not None and len(colors) > 0
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {len(vertices)}"]
    header += ["property float x", "property float y", "property float z"]
    if has_colors:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [
        f"element face {len(faces)}",
        "property list uchar int vertex_indices",
        "end_header",
    ]
    with open(filename, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if has_colors:
            col = np.clip(np.asarray(colors), 0, 255).astype(np.uint8)
            vdt = np.dtype([("xyz", "<f4", (3,)), ("rgb", "u1", (3,))])
            varr = np.zeros(len(vertices), dtype=vdt)
            varr["xyz"] = vertices
            varr["rgb"] = col
        else:
            vdt = np.dtype([("xyz", "<f4", (3,))])
            varr = np.zeros(len(vertices), dtype=vdt)
            varr["xyz"] = vertices
        f.write(varr.tobytes())
        fdt = np.dtype([("n", "u1"), ("idx", "<i4", (3,))])
        farr = np.zeros(len(faces), dtype=fdt)
        farr["n"] = 3
        farr["idx"] = faces
        f.write(farr.tobytes())


def load_ply(filename: str) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Minimal binary-little-endian PLY reader for meshes written by save_ply
    or the reference. Returns (vertices, faces, colors-or-None)."""
    with open(filename, "rb") as f:
        data = f.read()
    end = data.index(b"end_header") + len(b"end_header")
    header = data[:end].decode("ascii", errors="replace")
    body = data[end:]
    # skip the newline after end_header
    body = body[1:] if body[:1] in (b"\n", b"\r") else body
    if body[:1] == b"\n":
        body = body[1:]

    num_vertices = num_faces = 0
    vertex_props = []
    section = None
    for line in header.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "element":
            section = parts[1]
            if section == "vertex":
                num_vertices = int(parts[2])
            elif section == "face":
                num_faces = int(parts[2])
        elif parts[0] == "property" and section == "vertex" and parts[1] != "list":
            vertex_props.append((parts[1], parts[2]))

    fmt = {"float": "<f4", "uchar": "u1", "double": "<f8", "int": "<i4"}
    vdt = np.dtype([(name, fmt[t]) for t, name in vertex_props])
    varr = np.frombuffer(body[: num_vertices * vdt.itemsize], dtype=vdt)
    vertices = np.stack([varr["x"], varr["y"], varr["z"]], axis=-1).astype(np.float32)
    colors = None
    if "red" in vdt.names:
        colors = np.stack([varr["red"], varr["green"], varr["blue"]], axis=-1)

    fdt = np.dtype([("n", "u1"), ("idx", "<i4", (3,))])
    fbody = body[num_vertices * vdt.itemsize :]
    farr = np.frombuffer(fbody[: num_faces * fdt.itemsize], dtype=fdt)
    faces = np.ascontiguousarray(farr["idx"])
    return vertices, faces, colors
