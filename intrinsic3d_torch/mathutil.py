"""Math helpers: robust kernel, SDF weight, angle-axis poses.

Torch counterpart of `intrinsic3d_tpu/mathutil.py` (reference
``libintrinsic3d/src/math.cpp:43-179``). The pose-matrix conversions are
host-side numpy, copied verbatim.
"""

from __future__ import annotations

import numpy as np
import torch


def robust_kernel(val, thres=2.0):
    """`1 / (1 + t·x)^3` influence kernel (``math.cpp:43-47``)."""
    div = 1.0 + thres * val
    return 1.0 / (div * div * div)


def sdf_to_weight(sdf, truncation):
    """Closeness-to-isosurface weight in [0.01, 1] (``operators.cpp:142-147``)."""
    a = torch.clamp(torch.abs(sdf), max=truncation) / truncation
    return torch.clamp(1.0 - a, 0.01, 1.0)


def rotate_angle_axis(aa, pts):
    """Rotate points `[..., 3]` by angle-axis vectors `aa [..., 3]` (Rodrigues;
    `aa` broadcasts against `pts`).

    Branchless small-angle form: the series values of sin(θ)/θ and
    (1−cos θ)/θ² are selected below θ² = 1e-12, so the value is finite
    everywhere. As in the JAX package, the unselected branch still enters the
    reverse pass (0/0 at exactly θ = 0)."""
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + 1e-32)
    small = theta2 < 1e-12
    sin_t = torch.sin(theta)
    cos_t = torch.cos(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, sin_t / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - cos_t) / theta2)
    # R p = p cosθ + (k × p) sinθ + k (k·p)(1−cosθ), with k = aa/θ
    cross = torch.linalg.cross(aa, pts, dim=-1)  # broadcasts
    dot = torch.sum(pts * aa, dim=-1, keepdim=True)
    return pts * torch.where(small, 1.0 - theta2 * b, cos_t) + cross * a + aa * dot * b


def transform_points(pose6, pts):
    """Apply 6-vector poses (angle-axis + translation, `[..., 6]`
    broadcasting against `pts [..., 3]`) (``cost.h:80-89``)."""
    return rotate_angle_axis(pose6[..., :3], pts) + pose6[..., 3:]


def pose_vec_to_matrix(pose6) -> np.ndarray:
    """Angle-axis+translation 6-vector → 4x4 matrix (``math.cpp:151-165``)."""
    pose6 = np.asarray(pose6, dtype=np.float64)
    aa = pose6[:3]
    theta = np.linalg.norm(aa)
    R = np.eye(3)
    if theta > 1e-12:
        k = aa / theta
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = pose6[3:]
    return T


def pose_matrix_to_vec(T) -> np.ndarray:
    """4x4 matrix → angle-axis+translation 6-vector (``math.cpp:168-179``)."""
    T = np.asarray(T, dtype=np.float64)
    R = T[:3, :3]
    cos_theta = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(cos_theta)
    if theta < 1e-12:
        aa = np.zeros(3)
    elif abs(np.pi - theta) < 1e-6:
        # θ≈π: extract the axis from the symmetric part
        A = (R + np.eye(3)) * 0.5
        axis = np.sqrt(np.clip(np.diag(A), 0.0, None))
        i = int(np.argmax(axis))
        if axis[i] > 0:
            for j in range(3):
                if j != i and A[i, j] < 0:
                    axis[j] = -axis[j]
        axis = axis / (np.linalg.norm(axis) + 1e-32)
        aa = axis * theta
    else:
        v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        aa = v / (2.0 * np.sin(theta)) * theta
    out = np.zeros(6)
    out[:3] = aa
    out[3:] = T[:3, 3]
    return out


def invert_pose(T) -> np.ndarray:
    """Rigid-transform inverse."""
    T = np.asarray(T, dtype=np.float64)
    R = T[:3, :3]
    t = T[:3, 3]
    out = np.eye(4)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out
