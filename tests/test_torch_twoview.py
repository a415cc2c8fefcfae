"""The port's two-view reconstruction (ops/twoview.py) against the JAX
package's on the same matches and the same RANSAC draws: the port's
`sample` is replaced by jax.random.categorical under the reference's key
(test_torch_loop.JaxDraws), so both score the same 200 8-point sets.

Scenes: 400 matches at 352x240 (fx 260, the e2e tests' camera), 10% of
them invalid, a 0.06 rad yaw and 0.51 m of translation. General: depths
3-9 m, 0.3 px noise, 5% gross mismatches; the fundamental wins. Planar: a
tilted plane at 4-5 m, 0.5 px noise. On a plane the reference scores the
fundamental family at least as high as the homography (its 1-D epipolar
distance against the homography's 2-D transfer error), so it never picks
the homography there, and the fundamental it keeps is degenerate (a plane
leaves 8-point F a 3-dimensional null space): no two float32 solvers agree
on it. The planar case therefore runs with both packages' F scores halved,
which drives the homography branch (its 8 motions, CheckRT, the gates) end
to end.

Tolerances: `success` and `used_homography` equal; R and the unit t within
1e-4 (float32 eigen / SVD solves on both sides); `good` equal on all but 1%
of the rows; the triangulated points within 1e-3 relative where both call
them good.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu.ops import twoview as jtv
from orb_slam3_vio_fixes_tpu.utils.cameras import Camera as JCamera
from orb_slam3_vio_fixes_tpu_torch.ops import twoview as ttv
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera as TCamera

from test_torch_loop import JaxDraws

torch.set_num_threads(2)

K = np.array([[260.0, 0.0, 176.0], [0.0, 260.0, 120.0], [0.0, 0.0, 1.0]])


def _scene(planar: bool, n: int = 400, seed: int = 0):
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-3, 3, n), rng.uniform(-2, 2, n)
    z = 4.0 + 0.5 * y if planar else rng.uniform(3, 9, n)
    X = np.c_[x, y, z]
    a = 0.06
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    t = np.array([-0.5, 0.05, 0.1])

    def proj(P):
        p = P @ K.T
        return p[:, :2] / p[:, 2:]

    noise = 0.5 if planar else 0.3
    uv1 = proj(X) + rng.normal(0, noise, (n, 2))
    uv2 = proj(X @ R.T + t) + rng.normal(0, noise, (n, 2))
    valid = rng.random(n) > 0.1
    if not planar:
        bad = rng.random(n) < 0.05
        uv2[bad] += rng.uniform(-40, 40, (bad.sum(), 2))
    return uv1.astype(np.float32), uv2.astype(np.float32), valid


def _halve_f(score_f):
    def scaled(*a):
        s, inl = score_f(*a)
        return 0.5 * s, inl
    return scaled


@pytest.mark.parametrize("case", ["general", "planar"])
def test_reconstruct_agrees(case, monkeypatch):
    uv1, uv2, valid = _scene(planar=case != "general")
    key = jax.random.PRNGKey(3)
    if case == "planar":
        monkeypatch.setattr(jtv, "_score_f", _halve_f(jtv._score_f))
        monkeypatch.setattr(ttv, "_score_f", _halve_f(ttv._score_f))
    cam = (K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    # the un-jitted reference, so that the patched scoring is the one called
    jr = jtv.reconstruct.__wrapped__(key, jnp.asarray(uv1), jnp.asarray(uv2),
                                     jnp.asarray(valid), JCamera.pinhole(*cam))
    monkeypatch.setattr(ttv, "sample", JaxDraws(key, per_call=False, inner_split=False))
    tr = ttv.reconstruct(None, torch.as_tensor(uv1), torch.as_tensor(uv2),
                         torch.as_tensor(valid), TCamera.pinhole(*cam))
    assert bool(tr.success) == bool(jr.success)
    assert bool(tr.used_homography) == bool(jr.used_homography) == (case == "planar")
    assert bool(tr.success)
    assert np.abs(tr.R.numpy() - np.asarray(jr.R)).max() < 1e-4
    assert np.abs(tr.t.numpy() - np.asarray(jr.t)).max() < 1e-4
    good_j = np.asarray(jr.good)
    assert (tr.good.numpy() != good_j).mean() <= 0.01
    both = good_j & tr.good.numpy()
    Xj = np.asarray(jr.points)[both]
    assert np.abs(tr.points.numpy()[both] - Xj).max() < 1e-3 * np.abs(Xj).max()


def test_sample_draws_valid_rows():
    valid = torch.zeros(50, dtype=torch.bool)
    valid[[3, 17, 40]] = True
    idx = ttv.sample(torch.Generator().manual_seed(0), valid, 200, 8)
    assert idx.shape == (200, 8) and set(idx.unique().tolist()) <= {3, 17, 40}
