"""Shared pieces of the plain reference: voxel tables, stencils, the
camera model, rotations and the small formulas every stage uses.

Plain PyTorch on any device and dtype. The formulas follow the upstream
Intrinsic3D sources cited beside each; nothing here imports the program
under test.
"""

from __future__ import annotations

import torch

_BIAS = 1 << 20

RING6 = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))
NORMAL4 = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1))
# the shading cost's 10-voxel SDF stencil (shading_cost.cpp:87-110)
EG_SDF10 = ((0, 0, 0), (0, 1, 0), (0, 2, 0), (0, 1, 1), (0, 0, 1), (0, 0, 2), (1, 0, 0), (1, 1, 0), (1, 0, 1),
            (2, 0, 0))
# the 4 normal stencils inside the 10-voxel one: normal(v), (v+x), (v+y), (v+z)
N4_IN_10 = ((0, 6, 1, 4), (6, 9, 7, 8), (1, 7, 2, 3), (4, 8, 3, 5))
CORNERS8 = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (0, 1, 1), (1, 0, 1), (1, 1, 1))


def pack(c: torch.Tensor) -> torch.Tensor:
    """int voxel coords `[..., 3]` -> sortable int64 keys."""
    c = c.to(torch.int64) + _BIAS
    return (c[..., 0] << 42) | (c[..., 1] << 21) | c[..., 2]


class VoxelTable:
    """Index lookup of a voxel coordinate set `[N, 3]` (any order)."""

    def __init__(self, coords: torch.Tensor):
        self.coords = coords.to(torch.int64)
        keys = pack(self.coords)
        self.keys, self.perm = torch.sort(keys)

    def find(self, q: torch.Tensor) -> torch.Tensor:
        """Indices of query coords `[..., 3]`, -1 where absent."""
        qk = pack(q)
        pos = torch.searchsorted(self.keys, qk).clamp(max=max(len(self.keys) - 1, 0))
        hit = self.keys[pos] == qk
        return torch.where(hit, self.perm[pos], torch.full_like(pos, -1))

    def stencil(self, offsets) -> torch.Tensor:
        off = torch.tensor(offsets, dtype=torch.int64, device=self.coords.device)
        return self.find(self.coords[:, None, :] + off[None])


def table_from_blocks(coords, block_coords, block: int, dense: torch.Tensor) -> torch.Tensor:
    """A field stored as dense B³ blocks, read back in table order: the
    values of the voxels `coords [N, 3]` in `dense` (flat, or `[nb(+1),
    B³]`), where block n holds the voxels of block `block_coords[n]` and a
    voxel sits at lane (x·B + y)·B + z of its offset in the block. NaN where
    a voxel's block is not among `block_coords`."""
    dev = dense.device
    c = torch.as_tensor(coords, device=dev).to(torch.int64)
    bc = torch.div(c, block, rounding_mode="floor")
    row = VoxelTable(torch.as_tensor(block_coords, device=dev)).find(bc)
    lc = c - bc * block
    lane = (lc[:, 0] * block + lc[:, 1]) * block + lc[:, 2]
    out = dense.reshape(-1)[row.clamp(min=0) * block**3 + lane]
    return torch.where(row >= 0, out, torch.full_like(out, float("nan")))


def surface_normals(sdf, nbr4, valid):
    """Forward-difference normals (operators.cpp:58-77): zero unless the
    voxel and its +x, +y, +z neighbours are valid and the difference is
    nonzero. Returns (normals `[N, 3]`, ok `[N]`)."""
    nb_ok = torch.all((nbr4 >= 0) & valid[nbr4.clamp(min=0)], dim=-1)
    s = torch.where(nbr4 >= 0, sdf[nbr4.clamp(min=0)], torch.zeros((), dtype=sdf.dtype, device=sdf.device))
    n = torch.stack([s[:, 1] - s[:, 0], s[:, 2] - s[:, 0], s[:, 3] - s[:, 0]], dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    nonzero = norm[:, 0] > 0
    n = torch.where(nonzero[:, None], n / torch.where(norm == 0, torch.ones_like(norm), norm), torch.zeros_like(n))
    ok = nb_ok & nonzero
    return torch.where(ok[:, None], n, torch.zeros_like(n)), ok


def sh_basis(n):
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    return torch.stack(
        [torch.ones_like(nx), ny, nz, nx, nx * ny, ny * nz, -nx * nx - ny * ny + 2.0 * nz * nz, nx * nz,
         nx * nx - ny * ny],
        dim=-1,
    )


def robust_kernel(x, thres=2.0):
    d = 1.0 + thres * x
    return 1.0 / (d * d * d)


def rotate(aa, p):
    """Rodrigues rotation of points `p` by angle-axis `aa` (broadcasting)."""
    aa, p = torch.broadcast_tensors(aa, p)
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2)
    small = theta2 < 1e-12
    safe = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))
    c = torch.where(small, 1.0 - theta2 * b, torch.cos(safe))
    return p * c + torch.linalg.cross(aa, p, dim=-1) * a + aa * torch.sum(p * aa, -1, keepdim=True) * b


def transform(pose6, p):
    return rotate(pose6[..., :3], p) + pose6[..., 3:]


def distort(dist, x, y):
    """3 radial + 2 tangential coefficients (camera.cpp:136-143)."""
    k1, k2, k3, p1, p2 = dist[0], dist[1], dist[2], dist[3], dist[4]
    r2 = x * x + y * y
    r4 = r2 * r2
    rad = 1.0 + k1 * r2 + k2 * r4 + k3 * r4 * r2
    return x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x), y * rad + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)


def project(intr, dist, width, height, p):
    """Distorted projection of camera-frame points (camera.cpp:124-154):
    (u, v, valid) with valid = z > 0 and (u, v) inside the image."""
    z = p[..., 2]
    zs = torch.where(z == 0, torch.full_like(z, 1e-12), z)
    xd, yd = distort(dist, p[..., 0] / zs, p[..., 1] / zs)
    u = intr[0] * xd + intr[2]
    v = intr[1] * yd + intr[3]
    return u, v, (z > 0) & (u >= 0) & (u <= width - 1) & (v >= 0) & (v <= height - 1)


def intensity(rgb):
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def varying_lambda(it: int, iters: int, l0: float, l1: float) -> float:
    """Linear λ schedule over a level's iterations (cost.h:130-143)."""
    if iters <= 1:
        return l0
    return l0 + (l1 - l0) / float(iters - 1) * float(it)


def thin_shell(cfg: dict, grid_level: int, voxel_size: float) -> float:
    """The thin-shell threshold of a grid level (intrinsic3d.cpp:298-318)."""
    coarsest = int(cfg["num_grid_levels"]) - 1
    f = float(cfg["thin_shell_factor"])
    if float(cfg["thin_shell_factor_final"]) > 0.0:
        f = varying_lambda(coarsest - grid_level, int(cfg["num_grid_levels"]), f, float(cfg["thin_shell_factor_final"]))
    return f * voxel_size


def quantile(x: torch.Tensor, q: float) -> float:
    """The q-quantile of a 1-D tensor (0 when empty), by sorting."""
    if x.numel() == 0:
        return 0.0
    s, _ = torch.sort(x.reshape(-1).to(torch.float64))
    return float(s[min(int(q * (s.numel() - 1) + 0.5), s.numel() - 1)])
