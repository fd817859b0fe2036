"""The benchmark's capture against the port's orbit capture it froze."""

import numpy as np
import torch

from benchmark import scene

SCENE = dict(frames=6, width=80, height=60, center=[0.0, 0.0, 0.6], radius=0.12, orbit_factor=3.4, elevation=0.35,
             focal_factor=0.92, blur_every=3, noise_std=0.003)


class _NoNoise:
    def normal(self, loc, scale, size):
        return np.zeros(size)


def test_noise_free_capture_matches_the_port(monkeypatch):
    from intrinsic3d_torch import synthetic

    monkeypatch.setattr(synthetic.np.random, "default_rng", lambda seed=None: _NoNoise())
    want = synthetic.build_orbit_dataset(6, 80, 60, np.array(SCENE["center"]), SCENE["radius"])
    got = scene.render_orbit(SCENE, seed=5, device="cpu", noise=False, start=0)
    cam = want.color_cam
    assert (got.fx, got.fy, got.cx, got.cy) == (cam.fx, cam.fy, cam.cx, cam.cy)
    for i in range(6):
        np.testing.assert_allclose(got.poses[i].numpy(), want.pose(i), rtol=0, atol=1e-12)
        np.testing.assert_allclose(got.depths[i].numpy(), want._depths[i], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.colors[i].numpy(), want.color(i), rtol=0, atol=2e-6)


def test_every_seed_holds_the_same_views_in_another_order():
    a = scene.render_orbit(SCENE, seed=2**31 + 7, device="cpu")
    b = scene.render_orbit(SCENE, seed=2**31 + 7, device="cpu")
    assert torch.equal(a.colors, b.colors) and torch.equal(a.poses, b.poses)
    starts = {scene.start_view(s, 6, 3) for s in range(2**31, 2**31 + 40)}
    assert starts == {0, 3}
    seed = next(s for s in range(2**31, 2**31 + 40) if scene.start_view(s, 6, 3) == 3)
    c = scene.render_orbit(SCENE, seed=seed, device="cpu")
    d = scene.render_orbit(SCENE, seed=seed, device="cpu", noise=False)
    ref = scene.render_orbit(SCENE, seed=seed, device="cpu", noise=False, start=0)
    assert not torch.equal(a.colors, c.colors)
    # the same views, rolled by the start: poses, depths and noise-free images
    assert torch.equal(c.poses, torch.roll(ref.poses, -3, 0)) and torch.equal(c.depths, torch.roll(ref.depths, -3, 0))
    assert torch.equal(d.colors, torch.roll(ref.colors, -3, 0))
