"""Port parity of the small foundation helpers that the JAX package's own
tests pin (`tests/test_foundation.py`, `tests/test_image.py`):
`camera.project_simple`/`unproject`, `mathutil.interpolation_weights`/
`within_bounds`, `lighting.sh.shading_gradient_difference`,
`grid.ops.voxel_to_world` and `image.interp.bicubic`, on the same seeded
numpy inputs, float32 (rtol 1e-6 unless stated), plus the JAX tests'
properties on the port's side."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsic3d_tpu import camera as jcamera
from intrinsic3d_tpu import mathutil as jmathutil
from intrinsic3d_tpu.grid import ops as jops
from intrinsic3d_tpu.image import interp as jinterp
from intrinsic3d_tpu.lighting import sh as jsh

from intrinsic3d_torch import camera, mathutil
from intrinsic3d_torch.grid import ops
from intrinsic3d_torch.image import interp
from intrinsic3d_torch.lighting import sh

CAM = dict(fx=525.0, fy=520.0, cx=319.5, cy=239.5, width=640, height=480)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _pair(j_out, t_out):
    if isinstance(j_out, tuple):
        return [(np.asarray(a), b.numpy()) for a, b in zip(j_out, t_out)]
    return [(np.asarray(j_out), t_out.numpy())]


def _case(name):
    """(JAX output, port output) of one helper on shared seeded inputs."""
    rng = np.random.default_rng(HELPERS.index(name))
    if name in ("project_simple", "unproject"):
        jcam = jcamera.Camera.create(CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"], CAM["width"], CAM["height"])
        tcam = camera.Camera.create(CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"], CAM["width"], CAM["height"])
        if name == "project_simple":
            pts = rng.normal(0.0, 0.5, (64, 3)).astype(np.float32)
            pts[:, 2] = np.abs(pts[:, 2]) + 0.2
            pts[0, 2] = 0.0  # the guarded zero depth
            return jcamera.project_simple(jcam, jnp.asarray(pts)), camera.project_simple(tcam, _t(pts))
        u = rng.uniform(0, 640, 64).astype(np.float32)
        v = rng.uniform(0, 480, 64).astype(np.float32)
        d = rng.uniform(-0.5, 3.0, 64).astype(np.float32)  # some non-positive depths
        return jcamera.unproject(jcam, *map(jnp.asarray, (u, v, d))), camera.unproject(tcam, *map(_t, (u, v, d)))
    if name == "interpolation_weights":
        pos = rng.uniform(-4.0, 9.0, (5, 7, 3)).astype(np.float32)
        return jmathutil.interpolation_weights(jnp.asarray(pos)), mathutil.interpolation_weights(_t(pos))
    if name == "within_bounds":
        pos = rng.uniform(-1.0, 1.0, (200, 3)).astype(np.float32)
        b = (-0.5, 0.4, -0.2, 0.9, -0.7, 0.1)
        return jmathutil.within_bounds(b, jnp.asarray(pos)), mathutil.within_bounds(b, _t(pos))
    if name == "shading_gradient_difference":
        lum = rng.uniform(0.0, 1.0, (50, 4)).astype(np.float32)
        shd = rng.uniform(0.0, 1.0, (50, 4)).astype(np.float32)
        return (jsh.shading_gradient_difference(jnp.asarray(lum), jnp.asarray(shd)),
                sh.shading_gradient_difference(_t(lum), _t(shd)))
    if name == "voxel_to_world":
        c = rng.integers(-300, 300, (100, 3)).astype(np.int32)
        return jops.voxel_to_world(jnp.asarray(c), 0.004), ops.voxel_to_world(_t(c), 0.004)
    if name == "bicubic":
        img = rng.uniform(0.0, 1.0, (24, 32)).astype(np.float32)
        x = rng.uniform(-2.0, 34.0, 300).astype(np.float32)  # past both borders: clamped taps
        y = rng.uniform(-2.0, 26.0, 300).astype(np.float32)
        return jinterp.bicubic(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)), interp.bicubic(_t(img), _t(x), _t(y))
    raise KeyError(name)


HELPERS = ("project_simple", "unproject", "interpolation_weights", "within_bounds", "shading_gradient_difference",
           "voxel_to_world", "bicubic")


@pytest.mark.parametrize("name", HELPERS)
def test_helper_matches_jax(name):
    j_out, t_out = _case(name)
    for want, got in _pair(j_out, t_out):
        assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
        if got.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * float(np.max(np.abs(want))))


def test_project_unproject_roundtrip():
    """`test_foundation.py::test_camera_project_unproject_roundtrip` on the port."""
    cam = camera.Camera.create(**{k: CAM[k] for k in ("fx", "fy", "cx", "cy")}, width=640, height=480)
    u = torch.tensor([10.0, 320.0, 600.5])
    v = torch.tensor([20.0, 240.0, 470.25])
    d = torch.tensor([0.5, 1.0, 3.0])
    uvz = camera.project_simple(cam, camera.unproject(cam, u, v, d))
    torch.testing.assert_close(uvz, torch.stack([u, v, d], dim=-1), rtol=1e-5, atol=1e-4)


def test_interpolation_weights_sum_to_one():
    """`test_foundation.py::test_interpolation_weights` on the port."""
    corners, weights = mathutil.interpolation_weights(torch.tensor([1.25, 2.5, 3.75]))
    assert corners.shape == (8, 3) and weights.shape == (8,)
    torch.testing.assert_close(weights.sum(), torch.tensor(1.0))
    assert corners[0].tolist() == [1, 2, 3] and corners[7].tolist() == [2, 3, 4]
    torch.testing.assert_close(weights[0], torch.tensor(0.75 * 0.5 * 0.25))


def test_shading_gradient_difference_zero():
    """Equal luminance and shading give the residual floor √eps."""
    lum = _t(np.random.default_rng(7).uniform(size=(6, 4)).astype(np.float32))
    torch.testing.assert_close(sh.shading_gradient_difference(lum, lum), torch.full((6,), 1e-6))


def test_bicubic_reproduces_linear_functions_and_is_differentiable():
    """`test_image.py`'s bicubic properties on the port: exact on linear
    images away from the border, and a gradient equal to JAX's."""
    yy, xx = np.mgrid[0:20, 0:30].astype(np.float32)
    img = 0.3 * xx - 0.2 * yy + 1.0
    x = np.array([3.2, 10.7, 20.1], np.float32)
    y = np.array([2.5, 8.9, 15.3], np.float32)
    got = interp.bicubic(_t(img), _t(x), _t(y)).numpy()
    np.testing.assert_allclose(got, 0.3 * x - 0.2 * y + 1.0, rtol=1e-5)

    rough = np.random.default_rng(8).uniform(size=(10, 12)).astype(np.float32)
    xg = torch.tensor(4.2, requires_grad=True)
    (g,) = torch.autograd.grad(interp.bicubic(_t(rough), xg, torch.tensor(3.3)), xg)
    want = jax.grad(lambda x: jinterp.bicubic(jnp.asarray(rough), x, jnp.array(3.3)))(jnp.array(4.2))
    np.testing.assert_allclose(float(g), float(want), rtol=1e-5)
