"""Pinhole camera with 5-coefficient lens distortion.

Torch counterpart of `intrinsic3d_tpu/camera.py` (reference
``camera.cpp:124-199``, ``camera.h:92-126``): the camera record, the
3-radial + 2-tangential distortion, the distorted projection, and the
reference's camera and intrinsics text files (``camera.cpp:200-274``,
``sensor_i3d.cpp:147-181``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

Scalar = Union[float, torch.Tensor]


@dataclasses.dataclass
class Camera:
    """Intrinsics `fx, fy, cx, cy`, image size `(width, height)`, distortion
    `[k1, k2, k3, p1, p2]` (``camera.cpp:136-143``). Intrinsics are Python
    floats on the host (scene rendering) or 0-dim tensors on the device."""

    fx: Scalar
    fy: Scalar
    cx: Scalar
    cy: Scalar
    width: int
    height: int
    dist: Union[np.ndarray, torch.Tensor]  # [5]

    @classmethod
    def create(cls, fx, fy, cx, cy, width, height, dist=None) -> "Camera":
        """Host-side constructor: float32-rounded intrinsics, numpy distortion."""
        dist = np.zeros(5, np.float32) if dist is None else np.asarray(dist, np.float32)
        h = lambda v: float(np.float32(v))  # noqa: E731
        return cls(h(fx), h(fy), h(cx), h(cy), int(width), int(height), dist)

    @classmethod
    def from_matrix(cls, K, width, height, dist=None) -> "Camera":
        K = np.asarray(K)
        return cls.create(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width, height, dist)

    def matrix(self) -> np.ndarray:
        return np.array(
            [
                [float(self.fx), 0.0, float(self.cx)],
                [0.0, float(self.fy), float(self.cy)],
                [0.0, 0.0, 1.0],
            ],
            dtype=np.float32,
        )

    # -- file I/O (reference-compatible text format) -----------------------

    @classmethod
    def load(cls, filename: str) -> "Camera":
        """Load `w h / K(3x3) / dist(5)` text format (``camera.cpp:200-240``)."""
        vals = _read_floats(filename)
        w, h = int(vals[0]), int(vals[1])
        K = np.array(vals[2:11]).reshape(3, 3)
        dist = np.array(vals[11:16], dtype=np.float32)
        return cls.from_matrix(K, w, h, dist)

    def save(self, filename: str) -> None:
        """Write `w h / K rows / dist` text (``camera.cpp:242-274``); the
        intrinsics may be floats or 0-dim tensors on any device."""
        d = torch.as_tensor(self.dist).detach().cpu().numpy()
        with open(filename, "w") as f:
            f.write(f"{self.width} {self.height}\n")
            f.write(f"{float(self.fx)} 0 {float(self.cx)}\n")
            f.write(f"0 {float(self.fy)} {float(self.cy)}\n")
            f.write("0 0 1\n")
            f.write(" ".join(str(float(x)) for x in d) + "\n")


def _read_floats(filename: str):
    with open(filename) as f:
        return [float(t) for t in f.read().split()]


def load_intrinsics_matrix(filename: str) -> np.ndarray:
    """Parse the dataset's 4x4 intrinsics text file, returning the 3x3 K
    (``sensor_i3d.cpp:147-181``)."""
    vals = _read_floats(filename)
    M = np.array(vals[:16]).reshape(4, 4)
    return M[:3, :3].astype(np.float32)


def distort(dist, x, y):
    """3-radial + 2-tangential distortion of normalized image coords
    (``camera.cpp:136-143``)."""
    k1, k2, k3, p1, p2 = dist[0], dist[1], dist[2], dist[3], dist[4]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    radial = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
    return xd, yd


def project(cam: Camera, pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distorted projection of camera-frame points `[..., 3]` → pixel coords
    `[..., 2]` plus the validity mask (in bounds and z > 0)
    (``camera.cpp:124-154``)."""
    z = pts[..., 2]
    zsafe = torch.where(z == 0.0, torch.full_like(z, 1e-12), z)
    x = pts[..., 0] / zsafe
    y = pts[..., 1] / zsafe
    xd, yd = distort(cam.dist, x, y)
    u = cam.fx * xd + cam.cx
    v = cam.fy * yd + cam.cy
    uv = torch.stack([u, v], dim=-1)
    valid = (
        (z > 0.0)
        & (u >= 0.0)
        & (u <= cam.width - 1)
        & (v >= 0.0)
        & (v <= cam.height - 1)
    )
    return uv, valid


def project_simple(cam: Camera, pts: torch.Tensor) -> torch.Tensor:
    """Undistorted projection (``Camera::project2``, ``camera.cpp:157-162``):
    camera-frame points `[..., 3]` → `[..., 3]` = (u, v, z)."""
    z = pts[..., 2]
    zsafe = torch.where(z == 0.0, torch.full_like(z, 1e-12), z)
    u = pts[..., 0] * cam.fx / zsafe + cam.cx
    v = pts[..., 1] * cam.fy / zsafe + cam.cy
    return torch.stack([u, v, z], dim=-1)


def unproject(cam: Camera, u: torch.Tensor, v: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Back-project pixels at the given depth (``Camera::unproject2``,
    ``camera.cpp:192-199``); zero depth gives the zero point."""
    x = (u - cam.cx) / cam.fx
    y = (v - cam.cy) / cam.fy
    pts = torch.stack([x * depth, y * depth, depth], dim=-1)
    return torch.where(depth.unsqueeze(-1) > 0.0, pts, torch.zeros_like(pts))
