"""The port's mesh modules, visualization and their helpers against the JAX
package on the CPU.

Inputs: the analytic sphere grids of `tests/test_marching_cubes.py` and the
lit sphere of `tests/test_visualization.py`, rebuilt here from the same
numpy code, plus seeded colors and albedo so every color mode has signal.

Tolerances:
- marching cubes, marching tetrahedra, component filtering and the mesh
  metrics: exact (the same numpy and scipy code on the same arrays);
- `colorize`: atol 1e-3 on the 0..255 scale for the modes computed in
  float32 tensors (normals, lap, lum, lum_grad, albedo, shading, chroma):
  float32 against the JAX package's float32/float64 mix, and clip-then-scale
  against scale-then-clip (measured ≤ 1.2e-4, in the Laplacian mode; 0 to
  1.6e-5 in the others); exact for the voxel-color and subvolume modes (the
  same numpy code);
- the helpers (`chromacity`, `scalar_to_color`, `compute_shading`,
  `laplacian`): rtol 1e-6 against JAX's float32 results.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsic3d_tpu import color as jcolor
from intrinsic3d_tpu import visualization as jvis
from intrinsic3d_tpu.config import RefinementConfig as JRefinementConfig
from intrinsic3d_tpu.grid import ops as jops
from intrinsic3d_tpu.grid.voxel_grid import VoxelGrid as JVoxelGrid
from intrinsic3d_tpu.lighting import sh as jsh
from intrinsic3d_tpu.lighting.svsh import estimate_svsh as j_estimate_svsh
from intrinsic3d_tpu.mesh import extract as jextract
from intrinsic3d_tpu.mesh import marching_cubes as jmc
from intrinsic3d_tpu.mesh import metrics as jmetrics
from intrinsic3d_tpu.mesh import util as jutil

from intrinsic3d_torch import color, visualization as vis
from intrinsic3d_torch.config import RefinementConfig
from intrinsic3d_torch.grid import ops
from intrinsic3d_torch.grid.voxel_grid import RING6_OFFSETS, VoxelGrid
from intrinsic3d_torch.io.ply import load_ply
from intrinsic3d_torch.lighting import sh
from intrinsic3d_torch.lighting.subvolumes import Subvolumes
from intrinsic3d_torch.lighting.svsh import SVSHResult
from intrinsic3d_torch.mesh import extract, marching_cubes, metrics, util
from intrinsic3d_torch.synthetic import sphere_sdf

from torch_support import one_torch_thread  # noqa: F401

MODES = ["", "normals", "lap", "lum", "lum_grad", "albedo", "shading_sv", "shading_sv_const", "chroma", "subvol",
         "subvol_interp"]
EXACT_MODES = {"", "subvol", "subvol_interp"}


def _fields(g):
    return {f.name: getattr(g, f.name) for f in dataclasses.fields(VoxelGrid)}


def _pair(g: VoxelGrid):
    """The port's grid and a JAX grid over copies of the same arrays."""
    return g, JVoxelGrid(**{k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in _fields(g).items()})


def make_sphere_grid(voxel_size=0.01, radius=0.12, shell=5.0):
    """`tests/test_marching_cubes.py::make_sphere_grid`, for the port's grid."""
    rng = np.arange(-20, 21)
    X, Y, Z = np.meshgrid(rng, rng, rng, indexing="ij")
    coords = np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.int32)
    sdf = np.linalg.norm(coords * voxel_size, axis=1) - radius
    keep = np.abs(sdf) < shell * voxel_size
    grid = VoxelGrid.from_coords(voxel_size, coords[keep])
    gp = grid.coords * voxel_size
    grid.sdf[:] = (np.linalg.norm(gp, axis=1) - radius).astype(np.float32)
    grid.weight[:] = 1.0
    grid.color[:] = np.abs(gp) * 800.0
    return grid, radius


def random_sdf_grid():
    """The random-sign grid of `test_random_sdf_watertight` (every ambiguous
    face configuration), with seeded colors."""
    rng = np.arange(0, 10)
    X, Y, Z = np.meshgrid(rng, rng, rng, indexing="ij")
    coords = np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.int32)
    grid = VoxelGrid.from_coords(0.01, coords)
    r = np.random.default_rng(7)
    grid.sdf[:] = r.normal(0, 1, grid.num_voxels).astype(np.float32)
    grid.weight[:] = 1.0
    grid.color[:] = r.uniform(0, 255, (grid.num_voxels, 3)).astype(np.float32)
    return grid


def _assert_same_mesh(got, want):
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def sphere():
    return make_sphere_grid()


@pytest.mark.parametrize("which", ["sphere", "random"])
def test_marching_cubes_and_tets_match_jax(sphere, which):
    g = sphere[0] if which == "sphere" else random_sdf_grid()
    g, jg = _pair(g)
    mc = marching_cubes.extract_surface_mc(g)
    assert len(mc[1]) > 100
    _assert_same_mesh(mc, jmc.extract_surface_mc(jg))
    _assert_same_mesh(extract.extract_surface(g), jextract.extract_surface(jg))
    _assert_same_mesh(extract.extract_surface(g, method="tet"), jextract.extract_surface_tet(jg))
    # explicit fields and iso level
    sdf = g.sdf + np.float32(0.001)
    _assert_same_mesh(
        extract.extract_surface(g, sdf=sdf, colors=g.color * 0.5, iso=0.0005),
        jextract.extract_surface(jg, sdf=sdf, colors=g.color * 0.5, iso=0.0005),
    )


def test_marching_cubes_tables_match_jax():
    np.testing.assert_array_equal(marching_cubes.TRI_TABLE, jmc.TRI_TABLE)
    np.testing.assert_array_equal(marching_cubes.EDGE_TABLE, jmc.EDGE_TABLE)
    np.testing.assert_array_equal(marching_cubes.CUBE_EDGES, jmc.CUBE_EDGES)


def test_mesh_util_matches_jax():
    g = random_sdf_grid()
    v, f, c = marching_cubes.extract_surface_mc(g)
    # a far copy of a small piece makes a second component
    piece = f[:20]
    f2 = np.concatenate([f, piece + len(v)])
    v2 = np.concatenate([v, v + np.float32(1.0)])
    c2 = np.concatenate([c, c])
    got = util.remove_loose_components(v2, f2, c2)
    _assert_same_mesh(got, jutil.remove_loose_components(v2, f2, c2))
    assert len(got[1]) < len(f2)
    np.testing.assert_array_equal(util.remove_degenerate_faces(f2, v2), jutil.remove_degenerate_faces(f2, v2))
    _assert_same_mesh(util.remove_unused_vertices(v2, f2[:50], c2), jutil.remove_unused_vertices(v2, f2[:50], c2))


def test_mesh_metrics_match_jax(sphere):
    grid, radius = sphere
    v, f, _ = marching_cubes.extract_surface_mc(grid)
    analytic = lambda p: np.linalg.norm(p, axis=-1) - radius  # noqa: E731
    got = metrics.mesh_error_vs_analytic(v, f, analytic, num_samples=5000)
    assert got == jmetrics.mesh_error_vs_analytic(v, f, analytic, num_samples=5000)
    assert got["rms"] < 0.05 * grid.voxel_size
    vt, ft, _ = extract.extract_surface_tet(grid)
    got = metrics.chamfer_distance(v, f, vt, ft, num_samples=4000, seed=0)
    assert got == jmetrics.chamfer_distance(v, f, vt, ft, num_samples=4000, seed=0)
    pts = metrics.sample_surface(v, f, 500, seed=1)
    np.testing.assert_array_equal(pts, jmetrics.sample_surface(v, f, 500, seed=1))
    np.testing.assert_array_equal(metrics.point_to_mesh_distance(pts + 0.003, v, f),
                                  jmetrics.point_to_mesh_distance(pts + 0.003, v, f))


# ---------------------------------------------------------------------------
# Visualization
# ---------------------------------------------------------------------------

VOXEL = 0.01
CENTER = np.array([0.0, 0.0, 0.6])
RADIUS = 0.15


def sphere_grid(sbr=True):
    """`tests/test_observations_lighting.py::sphere_grid`, for the port's grid."""
    r = int((RADIUS + 6 * VOXEL) / VOXEL) + 1
    cc = np.stack(np.meshgrid(*([np.arange(-r, r + 1)] * 3), indexing="ij"), axis=-1).reshape(-1, 3)
    cc = cc + np.round(CENTER / VOXEL).astype(np.int64)
    g = VoxelGrid.from_coords(VOXEL, cc, sbr=sbr)
    pts = g.voxel_to_world()
    sdf = sphere_sdf(pts, CENTER, RADIUS).astype(np.float32)
    g = g.select(np.abs(sdf) < g.truncation)
    pts = g.voxel_to_world()
    g.sdf = sphere_sdf(pts, CENTER, RADIUS).astype(np.float32)
    g.weight[:] = 1.0
    if sbr:
        g.sdf_refined = g.sdf.copy()
        g.albedo[:] = 0.6
    return g


@pytest.fixture(scope="module", params=["lit_grid", "seeded_colors"])
def lit_pair(request):
    """`tests/test_visualization.py`'s lit sphere (albedo 0.6, black), and
    the same sphere with seeded colors, albedo and SDF noise. The JAX
    package estimates the lighting; the port's colorize gets the same
    subvolumes and coefficients."""
    g = sphere_grid(sbr=True)
    if request.param == "seeded_colors":
        rng = np.random.default_rng(11)
        g.color = rng.uniform(0, 255, (g.num_voxels, 3)).astype(np.float32)
        g.albedo = rng.uniform(0.2, 1.1, g.num_voxels).astype(np.float32)
        g.sdf_refined = (g.sdf + rng.normal(0, 0.002, g.num_voxels)).astype(np.float32)
        g.weight[rng.uniform(size=g.num_voxels) < 0.05] = 0.0
    g, jg = _pair(g)
    jres = j_estimate_svsh(jg, subvolume_size=0.2, lambda_reg=10.0, thres_shell=2 * VOXEL)
    assert jres is not None
    sub = jres.subvolumes
    res = SVSHResult(subvolumes=Subvolumes(size=sub.size, indices=sub.indices, keys=sub.keys),
                     coeffs=np.asarray(jres.coeffs))
    return g, jg, res, jres


@pytest.mark.parametrize("mode", MODES)
def test_colorize_matches_jax(lit_pair, mode):
    g, jg, res, jres = lit_pair
    got = vis.colorize(g, mode, lighting=res, device="cpu")
    want = np.asarray(jvis.colorize(jg, mode, lighting=jres))
    assert got.shape == want.shape == (g.num_voxels, 3)
    assert np.all(np.isfinite(got)) and got.min() >= 0.0 and got.max() <= 255.0
    if mode in EXACT_MODES:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_colorize_rejects_what_jax_rejects(lit_pair):
    g, *_ = lit_pair
    for mode in ("shading_sv", "subvol"):
        with pytest.raises(ValueError, match="lighting"):
            vis.colorize(g, mode, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        vis.colorize(g, "nope", device="cpu")


def test_output_modes_match_jax():
    flags = [f.name for f in dataclasses.fields(RefinementConfig) if f.name.startswith("output_mesh_")
             and f.name not in ("output_mesh_prefix", "output_mesh_largest_comp_only")]
    assert len(flags) == 10
    rng = np.random.default_rng(5)
    for _ in range(8):
        on = {k: bool(rng.integers(2)) for k in flags}
        for add in (True, False):
            assert vis.output_modes(RefinementConfig(**on), add) == jvis.output_modes(JRefinementConfig(**on), add)


@pytest.mark.parametrize("mode", ["", "albedo", "normals"])
def test_export_mesh_matches_jax(lit_pair, tmp_path, mode):
    """The exported PLY: the same name, faces and vertices; colors within
    one step of the uint8 cast (a float32 color at an integer boundary)."""
    g, jg, res, jres = lit_pair
    name = vis.export_mesh(g, str(tmp_path / "m"), mode, lighting=res, suffix="_g0_p0", device="cpu")
    jname = jvis.export_mesh(jg, str(tmp_path / "j"), mode, lighting=jres, suffix="_g0_p0")
    assert name.replace(str(tmp_path / "m"), "") == jname.replace(str(tmp_path / "j"), "")
    (v, f, c), (jv, jf, jc) = load_ply(name), load_ply(jname)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert len(f) > 100
    assert np.abs(c.astype(int) - jc.astype(int)).max() <= 1


def test_color_helpers_match_jax():
    rng = np.random.default_rng(6)
    rgb = rng.uniform(0, 255, (300, 3)).astype(np.float32)
    rgb[:5] = 0.0
    np.testing.assert_allclose(color.chromacity(torch.as_tensor(rgb)).numpy(),
                               np.asarray(jcolor.chromacity(jnp.asarray(rgb))), rtol=1e-6)
    s = rng.uniform(-0.5, 1.5, 300).astype(np.float32)
    for lo, hi in ((0.0, 1.0), (-0.2, 0.7)):
        np.testing.assert_allclose(color.scalar_to_color(torch.as_tensor(s), lo, hi).numpy(),
                                   np.asarray(jcolor.scalar_to_color(jnp.asarray(s), lo, hi)), rtol=1e-6, atol=1e-4)


def test_shading_and_laplacian_match_jax():
    rng = np.random.default_rng(7)
    coeffs = rng.normal(0, 0.5, (200, 9)).astype(np.float32)
    n = rng.normal(0, 1, (200, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    alb = rng.uniform(0, 1, 200).astype(np.float32)
    got = sh.compute_shading(torch.as_tensor(coeffs), torch.as_tensor(n), torch.as_tensor(alb)).numpy()
    want = np.asarray(jsh.compute_shading(jnp.asarray(coeffs), jnp.asarray(n), jnp.asarray(alb)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    g = sphere_grid(sbr=False)
    ring = g.neighbor_table(RING6_OFFSETS)
    assert (ring < 0).any()
    got = ops.laplacian(torch.as_tensor(g.sdf), torch.as_tensor(ring, dtype=torch.int64)).numpy()
    want = np.asarray(jops.laplacian(jnp.asarray(g.sdf), jnp.asarray(ring)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
