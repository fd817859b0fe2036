"""In-memory RGB-D sensor (copy of `intrinsic3d_tpu/io/memory_sensor.py`).

Serves synthetic scenes and tests through the Sensor interface the apps read:
`color_cam`, `depth_cam`, `num_frames`, `depth(i)`, `color(i)`, `pose(i)`,
`set_pose`. Frames are host numpy arrays; the apps move them to the device.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from intrinsic3d_torch.camera import Camera


class MemorySensor:
    def __init__(
        self,
        color_cam: Camera,
        depth_cam: Camera,
        colors: Sequence[np.ndarray],  # [H, W, 3] float 0..1
        depths: Sequence[np.ndarray],  # [Hd, Wd] meters
        poses_cam_to_world: Sequence[np.ndarray],
        depth_min: float = 0.1,
        depth_max: float = 10.0,
    ):
        self.color_cam = color_cam
        self.depth_cam = depth_cam
        self._colors = list(colors)
        self._depths = list(depths)
        self.poses_cam_to_world: List[np.ndarray] = [np.asarray(p) for p in poses_cam_to_world]
        self.depth_min = depth_min
        self.depth_max = depth_max

    @property
    def num_frames(self) -> int:
        return len(self._colors)

    def depth(self, i: int) -> np.ndarray:
        d = self._depths[i].copy()
        d[(d < self.depth_min) | (d > self.depth_max)] = 0.0
        return d

    def color(self, i: int) -> np.ndarray:
        return self._colors[i]

    def pose(self, i: int) -> np.ndarray:
        return self.poses_cam_to_world[i]

    def set_pose(self, i: int, pose: np.ndarray) -> None:
        self.poses_cam_to_world[i] = np.asarray(pose)
