"""Synthetic scenes: analytic sphere rendering, ready-made refinement
problems, and the orbit capture of the pipeline benchmark.

Counterpart of `intrinsic3d_tpu/synthetic.py` and of
`bench_pipeline.py::build_dataset`: the host rendering is the same numpy
code (the same `default_rng(seed)` draws give the same images), and the
refinement problem's device fields are torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from intrinsic3d_torch.camera import Camera
from intrinsic3d_torch.config import FusionConfig, KeyframesConfig, RefinementConfig
from intrinsic3d_torch.device import resolve_device
from intrinsic3d_torch.grid.voxel_grid import VoxelGrid
from intrinsic3d_torch.io.memory_sensor import MemorySensor
from intrinsic3d_torch.mathutil import invert_pose, pose_matrix_to_vec
from intrinsic3d_torch.refine.assembly import LevelTopology, build_assembly
from intrinsic3d_torch.refine.optimizer import LevelSetup, prepare_level
from intrinsic3d_torch.refine.residuals import Params


def np_sh_basis(n: np.ndarray) -> np.ndarray:
    """Numpy SH basis (host twin of lighting.sh.sh_basis)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    return np.stack(
        [
            np.ones_like(nx), ny, nz, nx,
            nx * ny, ny * nz, -nx * nx - ny * ny + 2.0 * nz * nz,
            nx * nz, nx * nx - ny * ny,
        ],
        axis=-1,
    )


DEFAULT_CENTER = np.array([0.0, 0.0, 0.6])
DEFAULT_RADIUS = 0.15
DEFAULT_LIGHT = np.array([0.7, 0.1, 0.3, -0.1, 0.0, 0.05, 0.02, 0.0, -0.03], np.float32)


def sphere_sdf(points: np.ndarray, center, radius: float) -> np.ndarray:
    return np.linalg.norm(np.asarray(points) - np.asarray(center), axis=-1) - radius


def refined_sdf_error(grid: VoxelGrid, center, radius: float) -> Tuple[float, float, float, int]:
    """On valid voxels with |sdf_refined| < one voxel: the median |refined −
    analytic sdf| of the sphere, its p90, the same median of the grid's
    unrefined `sdf`, and the voxel count (the bar of
    tests/test_intrinsic3d_e2e.py)."""
    true = sphere_sdf(grid.voxel_to_world(), center, radius)
    shell = grid.valid_mask() & (np.abs(grid.sdf_refined) < grid.voxel_size)
    err = np.abs(grid.sdf_refined[shell] - true[shell])
    err0 = np.abs(grid.sdf[shell] - true[shell])
    return float(np.median(err)), float(np.percentile(err, 90)), float(np.median(err0)), int(shell.sum())


def look_at_pose(eye, target, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """Camera-to-world pose, +z forward, y down (RGB-D convention)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, np.float64)
    right = np.cross(up, fwd)
    if np.linalg.norm(right) < 1e-9:
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    T = np.eye(4)
    T[:3, 0] = right
    T[:3, 1] = down
    T[:3, 2] = fwd
    T[:3, 3] = eye
    return T


def _pixel_ray_dirs(cam: Camera, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Camera-frame ray directions through pixel centers; nonzero distortion
    is inverted by fixed-point iteration (OpenCV's `undistortPoints` scheme)."""
    x = (xs - float(cam.cx)) / float(cam.fx)
    y = (ys - float(cam.cy)) / float(cam.fy)
    d = np.asarray(cam.dist, np.float64)
    if np.any(d != 0.0):
        k1, k2, k3, p1, p2 = d
        xd, yd = x, y
        x, y = xd.copy(), yd.copy()
        for _ in range(12):
            r2 = x * x + y * y
            radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
            x = (xd - dx) / radial
            y = (yd - dy) / radial
    return np.stack([x, y, np.ones_like(x)], axis=-1)


def render_sphere_depth(cam: Camera, pose_cam_to_world, center, radius) -> np.ndarray:
    h, w = cam.height, cam.width
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    dirs = _pixel_ray_dirs(cam, xs, ys)
    T = invert_pose(pose_cam_to_world)
    c = T[:3, :3] @ np.asarray(center, np.float64) + T[:3, 3]
    a = np.sum(dirs * dirs, axis=-1)
    b = -2.0 * np.sum(dirs * c, axis=-1)
    cc = np.dot(c, c) - radius * radius
    disc = b * b - 4 * a * cc
    hit = disc >= 0.0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a), 0.0)
    return np.where(hit & (t > 0), t, 0.0).astype(np.float32)


def default_albedo(pts) -> np.ndarray:
    return (
        0.55
        + 0.25
        * np.sin(25.0 * np.asarray(pts)[..., 0])
        * np.cos(18.0 * np.asarray(pts)[..., 1])
    )


def render_shading_image(
    cam: Camera, pose_c2w, center, radius, light, flat_albedo: Optional[float] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Intensity image consistent with the Lambertian SH image-formation model."""
    depth = render_sphere_depth(cam, pose_c2w, center, radius)
    h, w = depth.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    dirs = _pixel_ray_dirs(cam, xs, ys)
    T = np.asarray(pose_c2w)
    pts_w = (dirs * depth[..., None]) @ T[:3, :3].T + T[:3, 3]
    n = (pts_w - center) / radius
    alb = default_albedo(pts_w) if flat_albedo is None else flat_albedo
    shading = alb * (np_sh_basis(n) @ np.asarray(light, np.float64))
    return np.where(depth > 0, shading, 0.0).astype(np.float32), depth


@dataclasses.dataclass
class SphereProblem:
    """A complete joint-refinement problem instance (table-order Params)."""

    cfg: RefinementConfig
    cam: Camera
    grid: VoxelGrid
    topo: LevelTopology
    params: Params
    depths: torch.Tensor  # [K, H, W]
    images: torch.Tensor  # [K, H, W]
    voxel_sh: np.ndarray
    thres_shell: float

    def assemble(self):
        """The flat-table problem at the start point (`build_assembly` at
        pyramid scale 1, on the device the tensors lie on, with λ_r = λ_s =
        10 as `level()` and bench.py set them): (Assembly, Masks).
        Observations are collected through the TRUE camera (`self.cam`), as
        in the JAX package; the flat `optimize_level` collects them through
        the current intrinsics and distortion."""
        return build_assembly(
            self.grid, self.topo, self.params, self.cam, self.depths, self.images, self.voxel_sh, self.thres_shell,
            self.cfg.occlusion_distance, self.cfg.num_observations, self.cfg.lambda_g, 10.0, 10.0,
            self.cfg.lambda_a, 1.0, self.cfg.fix_poses, self.cfg.fix_intrinsics, self.cfg.fix_distortion,
            device=self.images.device,
        )

    def level(self, lambdas=None) -> LevelSetup:
        """The problem as one refinement level (`refine.optimizer.prepare_level`)
        on the device its tensors lie on. `lambdas` are the raw (λ_g, λ_r,
        λ_s, λ_a); by default (λ_g, 10, 10, λ_a), as bench.py sets them."""
        if lambdas is None:
            lambdas = (self.cfg.lambda_g, 10.0, 10.0, self.cfg.lambda_a)
        return prepare_level(
            self.grid, self.topo, self.voxel_sh, self.params, self.cfg, self.thres_shell,
            width=int(self.images.shape[2]), height=int(self.images.shape[1]), lambdas=lambdas,
            device=self.images.device,
        )


# The outer iteration bench.py times (bench.py:55-103): its problem, solver
# settings and starting damping
BENCH_PROBLEM = dict(
    voxel_size=0.004, image_size=(320, 240), num_frames=8, num_observations=5,
    perturb_sdf=0.001, perturb_albedo=0.03,
)
BENCH_SOLVER = dict(lm_steps=8, cg_iters=12, schur_globals=True, cg_coeff_dtype="bfloat16")
BENCH_MU0 = 1e-4


def build_sphere_problem(
    voxel_size: float = 0.01,
    image_size: Tuple[int, int] = (100, 80),
    num_frames: int = 3,
    num_observations: int = 3,
    center=DEFAULT_CENTER,
    radius: float = DEFAULT_RADIUS,
    light=DEFAULT_LIGHT,
    cfg: Optional[RefinementConfig] = None,
    seed: int = 0,
    perturb_sdf: float = 0.0,
    perturb_albedo: float = 0.0,
    dist=None,
    eyes=None,
    device="cuda",
) -> SphereProblem:
    """Build a shell grid around an analytic sphere, render consistent
    shading images from orbiting cameras, and package the problem with its
    tensors on `device`. `dist` (k1 k2 k3 p1 p2) renders through a distorted
    lens and sets `params.dist` to the true coefficients."""
    dev = resolve_device(device)
    cfg = cfg or RefinementConfig(num_observations=num_observations, occlusion_distance=0.02)
    w, h = image_size
    cam = Camera.create(1.1 * w, 1.1 * w, w / 2 - 0.5, h / 2 - 0.5, w, h, dist=dist)
    rng = np.random.default_rng(seed)
    if eyes is None:
        eyes = [[0.0, 0.0, 0.0]]
        for i in range(1, num_frames):
            ang = 2.0 * np.pi * i / max(num_frames, 2)
            eyes.append([0.45 * np.sin(ang), 0.2 * np.sin(2 * ang), 0.6 - 0.45 * np.cos(ang)])
    else:
        eyes = [list(e) for e in eyes]
        if len(eyes) != num_frames:
            raise ValueError(f"{len(eyes)} eyes given for {num_frames} frames")
    poses_c2w = [look_at_pose(e, center) for e in eyes]
    imgs, depths = [], []
    for T in poses_c2w:
        img, depth = render_shading_image(cam, T, center, radius, light)
        imgs.append(img)
        depths.append(depth)
    poses6 = np.stack([pose_matrix_to_vec(invert_pose(T)) for T in poses_c2w]).astype(np.float32)

    r = int((radius + 4 * voxel_size) / voxel_size) + 1
    cc = np.stack(np.meshgrid(*([np.arange(-r, r + 1)] * 3), indexing="ij"), axis=-1).reshape(-1, 3)
    cc = cc + np.round(np.asarray(center) / voxel_size).astype(np.int64)
    grid = VoxelGrid.from_coords(voxel_size, cc, sbr=True)
    pts = grid.voxel_to_world()
    sdf = sphere_sdf(pts, center, radius).astype(np.float32)
    grid = grid.select(np.abs(sdf) < grid.truncation * 0.8)
    pts = grid.voxel_to_world()
    grid.sdf = sphere_sdf(pts, center, radius).astype(np.float32)
    grid.sdf_refined = grid.sdf.copy()
    grid.weight[:] = 1.0
    grid.albedo = default_albedo(pts).astype(np.float32)
    nrm = (pts - center) / np.linalg.norm(pts - center, axis=-1, keepdims=True)
    shading = grid.albedo * (np_sh_basis(nrm) @ np.asarray(light, np.float64))
    grid.color = np.stack([np.clip(shading, 0, 1) * 255] * 3, axis=-1).astype(np.float32)

    sdf0 = grid.sdf_refined
    alb0 = grid.albedo
    if perturb_sdf > 0:
        sdf0 = sdf0 + rng.normal(0, perturb_sdf, grid.num_voxels).astype(np.float32)
    if perturb_albedo > 0:
        alb0 = np.clip(alb0 + rng.normal(0, perturb_albedo, grid.num_voxels), 0.05, 1.0).astype(np.float32)

    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    params = Params(
        sdf=t(sdf0),
        albedo=t(alb0),
        poses=t(poses6),
        intr=t([cam.fx, cam.fy, cam.cx, cam.cy]),
        dist=t(cam.dist),
    )
    return SphereProblem(
        cfg=cfg,
        cam=cam,
        grid=grid,
        topo=LevelTopology.build(grid),
        params=params,
        depths=t(np.stack(depths)),
        images=t(np.stack(imgs)),
        voxel_sh=np.broadcast_to(light, (grid.num_voxels, 9)).copy(),
        thres_shell=2.0 * voxel_size,
    )


# Stages 1 and 2 of bench_pipeline.py at its defaults: a 30-frame 640×480
# orbit around a 0.12 m sphere, keyframe window 3, fusion at 4 mm with
# discontinuity window 2 and clip bounds ±2.5·radius around the centre
PIPELINE_DATASET = dict(num_frames=30, width=640, height=480, center=DEFAULT_CENTER, radius=0.12)
PIPELINE_SETTINGS = dict(window_size=3, voxel_size=0.004, discont_window_size=2, clip_factor=2.5)


def build_orbit_dataset(num_frames, width, height, center, radius, seed=0) -> MemorySensor:
    """Orbit capture (`bench_pipeline.py::build_dataset`): cameras on a ring
    around the sphere with a mild elevation wobble, Lambertian SH shading of
    the default albedo texture, a 3×3 box blur on two frames of every three
    (so keyframe selection has signal) and seeded noise. Host numpy."""
    f = 0.92 * max(width, height)
    cam = Camera.create(f, f, (width - 1) / 2.0, (height - 1) / 2.0, width, height)
    rng = np.random.default_rng(seed)
    colors, depths, poses = [], [], []
    for i in range(num_frames):
        ang = 2.0 * np.pi * i / num_frames
        eye = np.asarray(center) + 3.4 * radius * np.array(
            [np.sin(ang), 0.35 * np.sin(2.1 * ang + 0.5), -np.cos(ang)]
        )
        T = look_at_pose(eye, center)
        img, depth = render_shading_image(cam, T, center, radius, DEFAULT_LIGHT)
        if i % 3 != 0:
            img = (np.roll(img, 1, 0) + img + np.roll(img, -1, 0)) / 3.0
            img = (np.roll(img, 1, 1) + img + np.roll(img, -1, 1)) / 3.0
        img = np.clip(img + rng.normal(0.0, 0.003, img.shape), 0.0, 1.0)
        colors.append(np.stack([img] * 3, axis=-1).astype(np.float32))
        depths.append(depth)
        poses.append(T)
    return MemorySensor(cam, cam, colors, depths, poses, depth_min=0.1, depth_max=2.0)


def pipeline_configs(
    center=DEFAULT_CENTER, radius: float = 0.12, window_size: int = 3, voxel_size: float = 0.004,
    discont_window_size: int = 2, clip_factor: float = 2.5,
):
    """(`KeyframesConfig`, `FusionConfig`) of bench_pipeline.py's stages 1
    and 2: clip bounds ±clip_factor·radius around `center`."""
    r = clip_factor * radius
    c = np.asarray(center, np.float64)
    fusion = FusionConfig(
        voxel_size=voxel_size, discont_window_size=discont_window_size,
        clip_x0=float(c[0] - r), clip_x1=float(c[0] + r),
        clip_y0=float(c[1] - r), clip_y1=float(c[1] + r),
        clip_z0=float(c[2] - r), clip_z1=float(c[2] + r),
    )
    return KeyframesConfig(window_size=window_size, filename=""), fusion


# Stage 3 of bench_pipeline.py (bench_pipeline.py:182-199) at its defaults: 3
# grid levels (4 mm → 1 mm) × 3 pyramid levels, 10 outer iterations a level,
# top-5 observations, 50 LM tries, poses refined, intrinsics and distortion
# fixed; Intrinsic3D's 12 CG steps
PIPELINE_REFINEMENT = RefinementConfig(
    num_grid_levels=3, num_rgbd_levels=3, num_observations=5, occlusion_distance=0.02, iterations=10,
    lm_steps=50, lambda_g=0.2, lambda_r0=80.0, lambda_r1=10.0, lambda_s0=120.0, lambda_s1=10.0, lambda_a=0.1,
    fix_poses=False, fix_intrinsics=True, fix_distortion=True, frame_bucketing="auto",
)
PIPELINE_CG_ITERS = 12

# `bench_pipeline.py --frames 90`: the same orbit with three times the
# frames, so keyframe selection (window 3) keeps 30 keyframes and the finest
# level's dense E_g elements (~88 M) exceed the card's budget: the planner
# buckets it (`PIPELINE_REFINEMENT`, frame_bucketing "auto")
PIPELINE_MANY_KF_DATASET = dict(PIPELINE_DATASET, num_frames=90)

# The scene of the JAX package's end-to-end test (tests/test_intrinsic3d_e2e.py):
# five views of the default sphere at 96×72, fused at 2 cm, refined over 2
# grid and 2 pyramid levels
SMALL_EYES = ([0.0, 0.0, 0.0], [0.4, 0.05, 0.2], [-0.35, -0.1, 0.25], [0.1, 0.4, 0.15], [-0.1, -0.4, 0.2])
SMALL_VOXEL = 0.02
SMALL_REFINEMENT = RefinementConfig(
    num_grid_levels=2, num_rgbd_levels=2, iterations=3, lm_steps=8, num_observations=3, occlusion_distance=0.04,
    subvolume_size_sh=0.3, lambda_r0=20.0, lambda_r1=10.0, lambda_s0=20.0, lambda_s1=10.0,
    fix_poses=True, fix_intrinsics=True, fix_distortion=True,
)
SMALL_CG_ITERS = 10


def small_refinement_sensor() -> MemorySensor:
    """The end-to-end test's capture: Lambertian SH shading of the default
    albedo on the default sphere, gray RGB in [0, 1]. Host numpy."""
    cam = Camera.create(90.0, 90.0, 47.5, 35.5, 96, 72)
    poses = [look_at_pose(e, DEFAULT_CENTER) for e in SMALL_EYES]
    colors, depths = [], []
    for T in poses:
        img, depth = render_shading_image(cam, T, DEFAULT_CENTER, DEFAULT_RADIUS, DEFAULT_LIGHT)
        colors.append(np.stack([np.clip(img, 0.0, 1.0)] * 3, axis=-1))
        depths.append(depth)
    return MemorySensor(cam, cam, colors, depths, poses, 0.1, 2.0)
