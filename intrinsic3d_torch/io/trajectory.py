"""TUM-format camera trajectory I/O.

Matches the reference's pose file handling
(``libintrinsic3d/src/rgbd/sensor.cpp:235-347``): each line is
``timestamp tx ty tz qx qy qz qw``; `#` comment lines are skipped.

Copy of `intrinsic3d_tpu/io/trajectory.py`.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _quat_to_matrix(qx, qy, qz, qw) -> np.ndarray:
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    if n > 0:
        qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
        ]
    )


def _matrix_to_quat(R) -> Tuple[float, float, float, float]:
    """Rotation matrix → (qx, qy, qz, qw)."""
    R = np.asarray(R, dtype=np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        qw = (R[2, 1] - R[1, 2]) / s
        qx = 0.25 * s
        qy = (R[0, 1] + R[1, 0]) / s
        qz = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        qw = (R[0, 2] - R[2, 0]) / s
        qx = (R[0, 1] + R[1, 0]) / s
        qy = 0.25 * s
        qz = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        qw = (R[1, 0] - R[0, 1]) / s
        qx = (R[0, 2] + R[2, 0]) / s
        qy = (R[1, 2] + R[2, 1]) / s
        qz = 0.25 * s
    return float(qx), float(qy), float(qz), float(qw)


def load_poses(filename: str) -> Tuple[List[np.ndarray], List[float]]:
    """Load TUM trajectory → (list of 4×4 poses, timestamps)."""
    poses: List[np.ndarray] = []
    timestamps: List[float] = []
    with open(filename) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(t) for t in line.split()]
            if len(vals) < 8:
                break
            ts, tx, ty, tz, qx, qy, qz, qw = vals[:8]
            T = np.eye(4)
            T[:3, :3] = _quat_to_matrix(qx, qy, qz, qw)
            T[:3, 3] = (tx, ty, tz)
            poses.append(T)
            timestamps.append(ts)
    return poses, timestamps


def save_poses(filename: str, poses: Sequence[np.ndarray], timestamps: Sequence[float]) -> None:
    """Write TUM trajectory (``sensor.cpp:315-347``)."""
    with open(filename, "w") as f:
        for ts, T in zip(timestamps, poses):
            t = T[:3, 3]
            qx, qy, qz, qw = _matrix_to_quat(T[:3, :3])
            f.write(
                f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n"
            )
