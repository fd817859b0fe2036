"""The benchmark's capture: an orbit of RGB-D frames around an analytic
textured sphere, rendered on the device from a seed.

A frozen torch copy of the arithmetic of the orbit capture the repository's
pipeline benchmark has always used (cameras on a ring around the sphere with
a mild elevation wobble, Lambertian second-order SH shading of a sinusoidal
albedo, a 3x3 box blur on two frames of every three so that keyframe
selection has signal, Gaussian image noise). It imports nothing of the
program under test, so a change to the program cannot change the inputs it
is measured on. The seed sets the image noise and the orbit's starting
view: the capture starts at view 3k of the ring (k drawn from the seed) and
goes round, so every seed holds the same views, the same sharp ones among
them, and hence the same keyframes and the same work, in another order.
"""

from __future__ import annotations

import dataclasses
import math

import torch

# second-order SH lighting of the scene (float32 values, as rendered)
LIGHT = (0.7, 0.1, 0.3, -0.1, 0.0, 0.05, 0.02, 0.0, -0.03)


@dataclasses.dataclass
class Capture:
    """Frames on the device: colors `[F, H, W, 3]` float32 in [0, 1], depths
    `[F, H, W]` float32 metres (0 = no hit), camera-to-world poses `[F, 4,
    4]` float64, and the pinhole intrinsics (float32-rounded)."""

    colors: torch.Tensor
    depths: torch.Tensor
    poses: torch.Tensor
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


def f32(v: float) -> float:
    """`v` rounded to float32, as the camera record stores intrinsics."""
    return float(torch.tensor(v, dtype=torch.float32))


def sh_basis(n: torch.Tensor) -> torch.Tensor:
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    return torch.stack(
        [torch.ones_like(nx), ny, nz, nx, nx * ny, ny * nz, -nx * nx - ny * ny + 2.0 * nz * nz, nx * nz,
         nx * nx - ny * ny],
        dim=-1,
    )


def look_at(eye: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Camera-to-world poses `[F, 4, 4]` of eyes `[F, 3]` looking at `target`
    (+z forward, y down; up is -y)."""
    fwd = target - eye
    fwd = fwd / torch.linalg.vector_norm(fwd, dim=-1, keepdim=True)
    up = torch.tensor([0.0, -1.0, 0.0], dtype=eye.dtype, device=eye.device).expand_as(fwd)
    right = torch.linalg.cross(up, fwd, dim=-1)
    right = right / torch.linalg.vector_norm(right, dim=-1, keepdim=True)
    down = torch.linalg.cross(fwd, right, dim=-1)
    T = torch.eye(4, dtype=eye.dtype, device=eye.device).repeat(eye.shape[0], 1, 1)
    T[:, :3, 0], T[:, :3, 1], T[:, :3, 2], T[:, :3, 3] = right, down, fwd, eye
    return T


def start_view(seed: int, frames: int, period: int) -> int:
    """The ring view the capture of `seed` starts at: a multiple of the blur
    period, so that the sharp views stay the sharp frames."""
    g = torch.Generator().manual_seed(int(seed))
    return period * int(torch.randint(max(frames // period, 1), (1,), generator=g))


def render_orbit(scene: dict, seed: int, device, noise: bool = True, start: int | None = None) -> Capture:
    """Render the orbit of `scene` (a configuration's "scene" group) on
    `device`. `noise=False` leaves the images noise-free; `start` overrides
    the seed's starting view."""
    n, w, h = int(scene["frames"]), int(scene["width"]), int(scene["height"])
    radius = float(scene["radius"])
    dev = torch.device(device)
    f64 = torch.float64
    center = torch.tensor(scene["center"], dtype=f64, device=dev)
    f = f32(scene["focal_factor"] * max(w, h))
    cx, cy = f32((w - 1) / 2.0), f32((h - 1) / 2.0)
    period = int(scene["blur_every"])
    first = start_view(seed, n, period) if start is None else int(start)
    views = (torch.arange(n, device=dev) + first) % n

    # an optional fraction of a view step turns the whole ring (0: view 0
    # looks along +z, the repository's orbit)
    ang = 2.0 * math.pi * (views.to(f64) + float(scene.get("phase", 0.0))) / n
    wob = float(scene["elevation"])
    eye = center + float(scene["orbit_factor"]) * radius * torch.stack(
        [torch.sin(ang), wob * torch.sin(2.1 * ang + 0.5), -torch.cos(ang)], dim=-1
    )
    poses = look_at(eye, center)

    ys, xs = torch.meshgrid(torch.arange(h, dtype=f64, device=dev), torch.arange(w, dtype=f64, device=dev),
                            indexing="ij")
    dirs = torch.stack([(xs - cx) / f, (ys - cy) / f, torch.ones_like(xs)], dim=-1)  # [H, W, 3]
    R, t = poses[:, :3, :3], poses[:, :3, 3]
    c = torch.einsum("fji,fj->fi", R, center - t)  # the centre in each camera frame
    a = torch.sum(dirs * dirs, dim=-1)
    b = -2.0 * torch.einsum("hwi,fi->fhw", dirs, c)
    cc = torch.sum(c * c, dim=-1)[:, None, None] - radius * radius
    disc = b * b - 4.0 * a * cc
    hit = disc >= 0.0
    tt = torch.where(hit, (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a), torch.zeros_like(b))
    depth = torch.where(hit & (tt > 0), tt, torch.zeros_like(tt)).to(torch.float32)

    pts = torch.einsum("fhwj,fij->fhwi", dirs[None] * depth.to(f64)[..., None], R) + t[:, None, None, :]
    nrm = (pts - center) / radius
    albedo = 0.55 + 0.25 * torch.sin(25.0 * pts[..., 0]) * torch.cos(18.0 * pts[..., 1])
    light = torch.tensor(LIGHT, dtype=torch.float32, device=dev).to(f64)
    img = torch.where(depth > 0, albedo * (sh_basis(nrm) @ light), torch.zeros_like(albedo)).to(torch.float32)

    blurred = (torch.arange(n, device=dev) % period) != 0
    box = (torch.roll(img, 1, 1) + img + torch.roll(img, -1, 1)) / 3.0
    box = (torch.roll(box, 1, 2) + box + torch.roll(box, -1, 2)) / 3.0
    img = torch.where(blurred[:, None, None], box, img).to(f64)
    if noise:
        g = torch.Generator(device=dev).manual_seed(int(seed))
        img = img + float(scene["noise_std"]) * torch.randn(img.shape, generator=g, dtype=f64, device=dev)
    img = torch.clamp(img, 0.0, 1.0).to(torch.float32)
    colors = img[..., None].expand(n, h, w, 3).contiguous()
    return Capture(colors=colors, depths=depth, poses=poses, fx=f, fy=f, cx=cx, cy=cy, width=w, height=h)
