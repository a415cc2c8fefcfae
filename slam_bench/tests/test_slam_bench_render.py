"""The benchmark's renderer: the vectorised PyTorch renderer against its
numpy painter's-loop twin, and against the sprite semantics of the SLAM
package's synthetic scenes, at small sizes on the CPU."""

import numpy as np
import pytest
import torch

from slam_bench import render

CAM = render.Camera(200.0, 199.0, 88.0, 60.0, 176, 120)


def world(seed, m=300, near=0.2):
    g = torch.Generator().manual_seed(seed)
    pts = torch.stack([torch.empty(m).uniform_(-4, 4, generator=g),
                       torch.empty(m).uniform_(-3, 3, generator=g),
                       torch.empty(m).uniform_(near, 9, generator=g)], 1)
    size = torch.empty(m).uniform_(0.06, 0.16, generator=g)
    tex = torch.empty(m, 12, 12).uniform_(70, 250, generator=g)
    return render.World(pts, size, tex)


POSES = [(np.eye(3), np.array([0.1, 0.0, 0.2])),
         (np.array([[np.cos(0.3), 0, np.sin(0.3)], [0, 1, 0], [-np.sin(0.3), 0, np.cos(0.3)]]),
          np.array([-0.4, 0.1, 0.5]))]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("pose", [0, 1])
def test_torch_renderer_equals_numpy_twin(seed, pose):
    w = world(seed)
    R, t = POSES[pose]
    got = render.render_many(w, CAM, R[None], t[None])[0].numpy()
    want = render.render_numpy(w.points.numpy(), w.size.numpy(), w.tex.numpy(), CAM, R, t)
    assert got.shape == (CAM.height, CAM.width)
    assert (got != render.BACKGROUND).mean() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_near_sprites_take_the_large_windows():
    """Sprites close to the near plane cover windows of hundreds of pixels,
    rendered in buckets of their own; nearer sprites hide farther ones."""
    w = world(5, m=200, near=0.31)
    pts = w.points.clone()
    pts[0] = torch.tensor([0.0, 0.0, 0.35])   # half-size ~ 0.1 * 200 / 0.35 = 57 px
    w = w._replace(points=pts)
    got = render.render_many(w, CAM, np.eye(3)[None], np.zeros((1, 3)))[0].numpy()
    want = render.render_numpy(pts.numpy(), w.size.numpy(), w.tex.numpy(), CAM, np.eye(3),
                               np.zeros(3))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_same_sprites_as_the_slam_packages_renderer():
    """The program's io/synthetic.render draws the same picture (float64
    texel weights there, float32 here)."""
    from orb_slam3_vio_fixes_tpu_torch.io import synthetic

    w = world(3)
    K = np.array([[CAM.fx, 0, CAM.cx], [0, CAM.fy, CAM.cy], [0, 0, 1]], np.float32)
    for R, t in POSES:
        got = render.render_many(w, CAM, R[None], t[None])[0].numpy()
        ref = synthetic.render(synthetic.SyntheticWorld(w.points.numpy(), w.size.numpy(),
                                                        w.tex.numpy()),
                               K, R.astype(np.float32), t.astype(np.float32),
                               CAM.height, CAM.width)
        close = np.abs(got - ref) <= 1e-2
        assert close.mean() >= 0.999
