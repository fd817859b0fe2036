"""Set-up shared by the port's CPU test files (`tests/test_torch_*.py` and
`tests/test_bench_factory_calib.py`). Pytest does not collect it.

A test file that does torch work takes the thread fixture by importing it:

    from torch_support import one_torch_thread  # noqa: F401

by this name, not as `tests.torch_support`: pytest puts `tests/` on the
path of the files it collects there, and a `tests` package installed on a
machine would shadow this directory as a package.

This module imports numpy, pytest and torch only, so the files that run on
a machine without JAX (`test_torch_kernels.py`, `test_torch_parallel_launch.py`)
can import it; `jgrid` and `jcam` import the JAX package when called.
"""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs test files in parallel worker processes: one intra-op
    thread per process keeps torch from oversubscribing the cores (with
    torch's default of one a core, `test_torch_eg_rows.py`'s ~10 s took ~30
    min of a six-worker run on an 8-core machine). Ranks that
    `intrinsic3d_torch.parallel.dryrun.launch` spawns split this count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels, and ranks that share the card, run only there")
    return torch.device("cuda")


def to_numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def tensor(a, dtype=torch.float32) -> torch.Tensor:
    """A CPU tensor of `dtype` over a copy of `a` (numpy or a JAX array)."""
    return torch.as_tensor(np.array(a), dtype=dtype)


def _f64(a) -> np.ndarray:
    return a.detach().to(torch.float64).cpu().numpy() if torch.is_tensor(a) else np.asarray(a, np.float64)


def close(got, want, rtol):
    """allclose with an absolute floor of `rtol` × the largest magnitude of
    `want`."""
    got, want = _f64(got), _f64(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(float(np.max(np.abs(want), initial=0.0)), 1e-30))


def close_in_norm(got, want, rtol=1e-4, elem=1e-3):
    """Relative error in norm at most `rtol`, and elementwise within `elem`
    of the field's largest magnitude."""
    got, want = _f64(got), _f64(want)
    scale = max(float(np.linalg.norm(want)), 1e-30)
    assert np.linalg.norm(got - want) <= rtol * scale, np.linalg.norm(got - want) / scale
    np.testing.assert_allclose(got, want, rtol=elem, atol=elem * float(np.max(np.abs(want), initial=0.0)))


def jgrid(g):
    """The JAX package's `VoxelGrid` over copies of a port grid's fields."""
    from intrinsic3d_tpu.grid.voxel_grid import VoxelGrid as JVoxelGrid

    c = lambda a: None if a is None else np.array(a)  # noqa: E731
    return JVoxelGrid(
        voxel_size=g.voxel_size, coords=c(g.coords), keys=c(g.keys), sdf=c(g.sdf), weight=c(g.weight),
        color=c(g.color), albedo=c(g.albedo), sdf_refined=c(g.sdf_refined), depth_min=g.depth_min,
        depth_max=g.depth_max, integration_weight_sample=g.integration_weight_sample,
    )


def jcam(cam):
    """The JAX package's `Camera` of a port camera (its distortion too)."""
    from intrinsic3d_tpu.camera import Camera as JCamera

    return JCamera.create(cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height, np.asarray(cam.dist))


def random_field(shape, density=0.3, seed=0):
    """A seeded dense sdf window and weights, `density` of them valid."""
    rng = np.random.default_rng(seed)
    sdf = rng.normal(0.0, 0.05, shape).astype(np.float32)
    w = (rng.uniform(size=shape) < density).astype(np.float32) * rng.uniform(1.0, 5.0, shape).astype(np.float32)
    return sdf, w
