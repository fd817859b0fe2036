"""Intrinsic3D dataset reader.

Re-design of ``nv::SensorI3d`` (``libintrinsic3d/src/rgbd/sensor_i3d.cpp``):
scans ``frame-%06d.{depth.png,color.png,pose.txt}`` triplets plus
``colorIntrinsics.txt``/``depthIntrinsics.txt``, decodes 16-bit depth PNGs in
millimeters (÷1000 → meters, ``sensor_i3d.cpp:307-316``), and serves per-frame
color (RGB float [0,1]), depth (f32 meters, min/max thresholded), and 4×4
camera-to-world poses. Unlike the reference (which keeps compressed PNG bytes in
RAM and re-decodes on every access), frames are decoded lazily with a small LRU —
the pipeline reads each frame once per stage and moves it to the device. PNGs
are decoded with Pillow, as in the JAX package.

Copy of `intrinsic3d_tpu/io/dataset.py`.
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional

import numpy as np

from intrinsic3d_torch.camera import Camera, load_intrinsics_matrix
from intrinsic3d_torch.config import SensorConfig


def _load_png(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def load_depth_png(path: str) -> np.ndarray:
    """16-bit depth PNG in millimeters → float32 meters."""
    arr = _load_png(path)
    return arr.astype(np.float32) / 1000.0


def load_color_png(path: str) -> np.ndarray:
    """Color PNG → float32 RGB in [0, 1]."""
    arr = _load_png(path)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr[..., :3].astype(np.float32) / 255.0


def load_pose_txt(path: str) -> np.ndarray:
    """4×4 camera-to-world pose text file (``sensor_i3d.cpp:256-290``)."""
    with open(path) as f:
        vals = [float(t) for t in f.read().split()]
    return np.array(vals[:16], dtype=np.float64).reshape(4, 4)


class SensorI3D:
    """RGB-D dataset access with the reference Sensor's semantics."""

    def __init__(self, folder: str, cfg: Optional[SensorConfig] = None):
        cfg = cfg or SensorConfig()
        self.folder = folder
        self.depth_min = cfg.min_depth
        self.depth_max = cfg.max_depth

        self.depth_files: List[str] = []
        self.color_files: List[str] = []
        pose_files: List[str] = []
        i = 0
        while True:
            base = os.path.join(folder, f"frame-{i:06d}")
            if not os.path.exists(base + ".depth.png"):
                break
            self.depth_files.append(base + ".depth.png")
            self.color_files.append(base + ".color.png")
            pose_files.append(base + ".pose.txt")
            i += 1
            if cfg.max_frames > 0 and i >= cfg.max_frames:
                break
        if not self.depth_files:
            raise FileNotFoundError(f"no frame-*.depth.png files in {folder}")

        self.poses_cam_to_world = [load_pose_txt(p) for p in pose_files]

        color_k = os.path.join(folder, "colorIntrinsics.txt")
        depth_k = os.path.join(folder, "depthIntrinsics.txt")
        c0 = _load_png(self.color_files[0])
        d0 = _load_png(self.depth_files[0])
        self.color_cam = Camera.from_matrix(
            load_intrinsics_matrix(color_k), c0.shape[1], c0.shape[0]
        )
        self.depth_cam = Camera.from_matrix(
            load_intrinsics_matrix(depth_k), d0.shape[1], d0.shape[0]
        )

    @property
    def num_frames(self) -> int:
        return len(self.depth_files)

    @functools.lru_cache(maxsize=32)
    def depth(self, i: int) -> np.ndarray:
        """Thresholded depth in meters (``sensor.cpp:196, 211-220``)."""
        d = load_depth_png(self.depth_files[i])
        d[(d < self.depth_min) | (d > self.depth_max)] = 0.0
        return d

    @functools.lru_cache(maxsize=32)
    def color(self, i: int) -> np.ndarray:
        return load_color_png(self.color_files[i])

    def pose(self, i: int) -> np.ndarray:
        return self.poses_cam_to_world[i]

    def set_pose(self, i: int, pose: np.ndarray) -> None:
        self.poses_cam_to_world[i] = np.asarray(pose, dtype=np.float64)
