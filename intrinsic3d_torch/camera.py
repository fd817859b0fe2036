"""Pinhole camera with 5-coefficient lens distortion.

Torch counterpart of `intrinsic3d_tpu/camera.py` (reference
``camera.cpp:124-199``, ``camera.h:92-126``): the camera record, the
3-radial + 2-tangential distortion and the distorted projection. File I/O
stays in the JAX package until the port reaches the apps.
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
