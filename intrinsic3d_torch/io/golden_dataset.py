"""Synthetic golden dataset exporter: writes an analytic orbit-capture scene
to disk in the reference's on-disk dataset layout.

Produces exactly what ``nv::SensorI3d`` consumes (reference
``libintrinsic3d/src/rgbd/sensor_i3d.cpp:184-220``): ``frame-%06d.color.png``
(8-bit RGB), ``frame-%06d.depth.png`` (16-bit millimeters), ``frame-%06d.pose.txt``
(4x4 camera-to-world), ``colorIntrinsics.txt``/``depthIntrinsics.txt`` (4x4),
plus the four stage configs (``sensor.yml``/``keyframes.yml``/``fusion.yml``/
``intrinsic3d.yml``) in OpenCV-YAML form — so the three CLI apps run on it
unchanged, and a real dataset (e.g. Lion) slots into the same harness by just
pointing at its folder.

The scene is the package's analytic textured sphere under SH lighting
(`intrinsic3d_torch.synthetic`), rendered from an orbit with mild elevation
wobble so every frame sees the object (the K-scaling worst case), with a
repeatable blur/noise pattern so keyframe selection has signal. Everything is
seeded — the same arguments always produce a bit-identical dataset, which is
what lets artifacts produced from it be pinned as goldens.

Copy of `intrinsic3d_tpu/io/golden_dataset.py`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class GoldenSceneSpec:
    """Pinned description of the synthetic golden scene."""

    num_frames: int = 12
    width: int = 160
    height: int = 120
    center: Tuple[float, float, float] = (0.0, 0.0, 0.6)
    radius: float = 0.12
    voxel_size: float = 0.01
    grid_levels: int = 2
    rgbd_levels: int = 2
    iterations: int = 3
    num_observations: int = 4
    window_size: int = 3
    seed: int = 7
    noise: float = 0.003
    # E_g element layout knob written into intrinsic3d.yml
    frame_bucketing: str = "auto"

    # The realistic-scale variant: 640x480, 30 frames, 4 mm -> 1 mm over 3
    # grid levels and 3 RGB-D levels (the scale of bench_pipeline.py)
    @classmethod
    def full_scale(cls) -> "GoldenSceneSpec":
        return cls(
            num_frames=30,
            width=640,
            height=480,
            voxel_size=0.004,
            grid_levels=3,
            rgbd_levels=3,
            iterations=10,
            num_observations=5,
            seed=7,
        )


def _write_pose_txt(path: str, T: np.ndarray) -> None:
    with open(path, "w") as f:
        for row in np.asarray(T):
            f.write(" ".join(f"{v:.9f}" for v in row) + "\n")


def _write_intrinsics_txt(path: str, K: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write(
            f"{K[0, 0]} 0 {K[0, 2]} 0\n0 {K[1, 1]} {K[1, 2]} 0\n0 0 1 0\n0 0 0 1\n"
        )


def render_orbit_frame(cam, spec: GoldenSceneSpec, i: int, rng: np.random.Generator):
    """One orbit frame: (intensity image f32 [0,1], depth f32 m, pose c2w)."""
    from intrinsic3d_torch.synthetic import (
        DEFAULT_LIGHT,
        look_at_pose,
        render_shading_image,
    )

    center = np.asarray(spec.center)
    ang = 2.0 * np.pi * i / spec.num_frames
    eye = center + 3.4 * spec.radius * np.array(
        [np.sin(ang), 0.35 * np.sin(2.1 * ang + 0.5), -np.cos(ang)]
    )
    T = look_at_pose(eye, center)
    img, depth = render_shading_image(cam, T, center, spec.radius, DEFAULT_LIGHT)
    if i % 3 != 0:  # repeatable blur so keyframe selection has signal
        img = (np.roll(img, 1, 0) + img + np.roll(img, -1, 0)) / 3.0
        img = (np.roll(img, 1, 1) + img + np.roll(img, -1, 1)) / 3.0
    img = np.clip(img + rng.normal(0.0, spec.noise, img.shape), 0.0, 1.0)
    return img.astype(np.float32), depth, T


def export_sphere_dataset(root: str, spec: Optional[GoldenSceneSpec] = None) -> str:
    """Write the complete on-disk dataset + configs under ``root``.

    Returns the path to ``sensor.yml`` (the apps' ``-s`` argument).
    """
    from PIL import Image

    from intrinsic3d_torch.camera import Camera

    spec = spec or GoldenSceneSpec()
    rgbd = os.path.join(root, "rgbd")
    os.makedirs(rgbd, exist_ok=True)

    f = 0.92 * max(spec.width, spec.height)
    cam = Camera.create(
        f, f, (spec.width - 1) / 2.0, (spec.height - 1) / 2.0, spec.width, spec.height
    )
    rng = np.random.default_rng(spec.seed)
    for i in range(spec.num_frames):
        img, depth, T = render_orbit_frame(cam, spec, i, rng)
        rgb = (np.clip(np.stack([img] * 3, -1), 0, 1) * 255).astype(np.uint8)
        Image.fromarray(rgb).save(os.path.join(rgbd, f"frame-{i:06d}.color.png"))
        d16 = np.round(depth * 1000.0).astype(np.uint16)
        Image.fromarray(d16).save(os.path.join(rgbd, f"frame-{i:06d}.depth.png"))
        _write_pose_txt(os.path.join(rgbd, f"frame-{i:06d}.pose.txt"), T)

    K = cam.matrix()
    _write_intrinsics_txt(os.path.join(rgbd, "colorIntrinsics.txt"), K)
    _write_intrinsics_txt(os.path.join(rgbd, "depthIntrinsics.txt"), K)

    cz = spec.center[2]
    r = spec.radius
    configs = {
        "sensor.yml": (
            'dataset: "./rgbd/"\nmax_frames: "0"\nmin_depth: "0.1"\nmax_depth: "2.0"\n'
        ),
        "keyframes.yml": (
            f'window_size: "{spec.window_size}"\n'
            'filename: "./fusion/keyframes.txt"\n'
        ),
        "fusion.yml": (
            'keyframes: ""\n'
            f'voxel_size: "{spec.voxel_size}"\n'
            'discont_window_size: "2"\n'
            f'clip_x0: "{spec.center[0] - 2.5 * r}"\nclip_x1: "{spec.center[0] + 2.5 * r}"\n'
            f'clip_y0: "{spec.center[1] - 2.5 * r}"\nclip_y1: "{spec.center[1] + 2.5 * r}"\n'
            f'clip_z0: "{cz - 2.5 * r}"\nclip_z1: "{cz + 2.5 * r}"\n'
            'output_mesh: "./fusion/mesh.ply"\n'
            'output_sdf: "./fusion/volume.tsdf"\n'
        ),
        "intrinsic3d.yml": (
            'keyframes: "./fusion/keyframes.txt"\n'
            'input_sdf: "./fusion/volume.tsdf"\n'
            f'num_grid_levels: "{spec.grid_levels}"\n'
            f'num_rgbd_levels: "{spec.rgbd_levels}"\n'
            'thin_shell_factor: "2.0"\nthin_shell_factor_final: "1.0"\n'
            'subvolume_size_sh: "0.15"\nsubvolume_sh_lamda_reg: "10.0"\n'
            'clear_distant_voxels: "1"\nocclusion_distance: "0.02"\n'
            f'num_observations: "{spec.num_observations}"\n'
            'lambda_g: "0.2"\nlambda_r0: "80.0"\nlambda_r1: "10.0"\n'
            'lambda_s0: "120.0"\nlambda_s1: "10.0"\nlambda_a: "0.1"\n'
            f'iterations: "{spec.iterations}"\nlm_steps: "50"\n'
            f'frame_bucketing: "{spec.frame_bucketing}"\n'
            'fix_poses: "0"\nfix_intrinsics: "1"\nfix_distortion: "1"\n'
            'output_mesh_prefix: "./intrinsic3d/mesh"\n'
            'output_mesh_albedo: "1"\n'
            'output_mesh_largest_comp_only: "1"\n'
            'output_poses_prefix: "./intrinsic3d/poses"\n'
            'output_intrinsics_prefix: "./intrinsic3d/intrinsics"\n'
        ),
    }
    for name, body in configs.items():
        with open(os.path.join(root, name), "w") as fh:
            fh.write("%YAML:1.0\n" + body)
    return os.path.join(root, "sensor.yml")
