"""The port's Sim3 (ops/sim3.py) and PnP (ops/pnp.py) against the JAX
package's, with the RANSAC index sets drawn by jax.random in the test and
fed to both (the port's `sim3_from_samples` / `pnp_from_samples`).

Tolerances: Horn alignment within 2e-5 (a 3x3 SVD in float32 on both
sides); RANSAC winners and inlier masks exact, their refits within 1e-4;
Sim3 Gauss-Newton within 1e-4 (rotation, scale) and 5e-4 m; MLPnP
Gauss-Newton within 1e-4; PnP RANSAC outcome: the same inlier count (+-1),
rotation within 1e-3 and translation within 1e-2 m of each other and of
the truth (0.5 px noise, up to 30% outliers). The port normalises the sign of each DLT solution, where the
reference keeps the eigensolver's sign and so loses about half of its
hypotheses to the cheirality gate (test_dlt_sign_normalised prints the
share): the hypotheses that get polished differ, so PnP is compared by
outcome.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu.ops import pnp as jpnp
from orb_slam3_vio_fixes_tpu.ops import sim3 as jsim3
from orb_slam3_vio_fixes_tpu.utils import lie as jlie
from orb_slam3_vio_fixes_tpu.utils.cameras import Camera as JCamera
from orb_slam3_vio_fixes_tpu_torch.ops import pnp as tpnp
from orb_slam3_vio_fixes_tpu_torch.ops import sim3 as tsim3
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera as TCamera

from test_pnp import make_problem

torch.set_num_threads(2)

JCAM = JCamera.pinhole(300.0, 300.0, 160.0, 120.0)
TCAM = TCamera.pinhole(300.0, 300.0, 160.0, 120.0)


def T(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def sim3_problem(seed, n=120, outliers=0.25, scale=1.0):
    """Camera-frame point pairs pts1 = s R pts2 + t with outliers."""
    rng = np.random.default_rng(seed)
    pts2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                     rng.uniform(4, 8, n)], 1).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.1, 3), jnp.float32)))
    t = rng.normal(0, 0.2, 3).astype(np.float32)
    pts1 = (scale * pts2 @ R.T + t).astype(np.float32)
    pts1 += rng.normal(0, 0.003, pts1.shape).astype(np.float32)
    bad = rng.choice(n, int(outliers * n), replace=False)
    pts1[bad] += rng.uniform(-1, 1, (len(bad), 3)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    s2 = (1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32)
    inlier = np.ones(n, bool)
    inlier[bad] = False
    return pts1, pts2, valid, s2, s2[::-1].copy(), (R, t, scale, inlier)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_alignment(fix_scale, seed):
    rng = np.random.default_rng(seed)
    src = rng.normal(0, 1, (5, 7, 3)).astype(np.float32)
    dst = (1.3 * src @ np.asarray(jlie.so3_exp(jnp.asarray([0.1, -0.2, 0.3])).T)
           + 0.5 + rng.normal(0, 0.01, src.shape)).astype(np.float32)
    w = rng.uniform(0, 1, (5, 7)).astype(np.float32)
    jR, jt, js = jsim3.horn_alignment(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
                                      fix_scale)
    tR, tt, ts = tsim3.horn_alignment(T(src), T(dst), T(w), fix_scale)
    for a, b in ((tR, jR), (tt, jt), (ts, js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)


@pytest.mark.parametrize("seed", [1, 5, 9])
@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_same_samples(fix_scale, seed):
    pts1, pts2, valid, s2a, s2b, _ = sim3_problem(seed, scale=1.0 if fix_scale else 1.15)
    key = jax.random.PRNGKey(seed + 3)
    j = jsim3.sim3_ransac(key, jnp.asarray(pts1), jnp.asarray(pts2), jnp.asarray(valid),
                          JCAM, JCAM, jnp.asarray(s2a), jnp.asarray(s2b), n_hyp=64,
                          fix_scale=fix_scale)
    idx = jax.random.categorical(jax.random.split(key)[0],
                                 jnp.where(jnp.asarray(valid), 0.0, -1e9)[None, :],
                                 shape=(64, 3))
    t = tsim3.sim3_from_samples(T(idx, torch.int64), T(pts1), T(pts2), T(valid), TCAM,
                                TCAM, T(s2a), T(s2b), fix_scale=fix_scale)
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    assert int(t.n_inliers) == int(j.n_inliers) > 60
    np.testing.assert_allclose(t.R.numpy(), np.asarray(j.R), atol=1e-4)
    np.testing.assert_allclose(t.t.numpy(), np.asarray(j.t), atol=1e-4)
    assert abs(float(t.s) - float(j.s)) < 1e-4


@pytest.mark.parametrize("seed", [2, 3])
@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_refine(fix_scale, seed):
    pts1, pts2, valid, s2a, s2b, (R, t_, s_, inl) = sim3_problem(
        seed, scale=1.0 if fix_scale else 0.9)
    # the RANSAC winner's neighbourhood and inliers, as the loop closer calls it
    R0 = (np.asarray(jlie.so3_exp(jnp.asarray([0.01, 0.02, -0.01]))) @ R).astype(np.float32)
    t0 = (t_ + 0.03).astype(np.float32)
    s0 = np.float32(s_ * 1.02)
    args = (pts1, pts2, valid & inl)
    j = jsim3.sim3_refine(jnp.asarray(R0), jnp.asarray(t0), jnp.float32(s0),
                          *map(jnp.asarray, args), JCAM, JCAM, jnp.asarray(s2a),
                          jnp.asarray(s2b), fix_scale=fix_scale)
    t = tsim3.sim3_refine(T(R0), T(t0), float(s0), *map(T, args), TCAM, TCAM,
                          T(s2a), T(s2b), fix_scale=fix_scale)
    np.testing.assert_allclose(t.R.numpy(), np.asarray(j.R), atol=1e-4)
    np.testing.assert_allclose(t.t.numpy(), np.asarray(j.t), atol=5e-4)
    assert abs(float(t.s) - float(j.s)) < 1e-4
    assert abs(int(t.n_inliers) - int(j.n_inliers)) <= 1
    assert int(t.n_inliers) > 60
    np.testing.assert_allclose(t.R.numpy(), R, atol=5e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_mlpnp_gauss_newton(seed):
    rng = np.random.default_rng(seed)
    cam, X, uv, R, t, _ = make_problem(rng, n=150, noise=0.5)
    xn = np.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], -1)
    bear = np.concatenate([xn, np.ones((len(X), 1), np.float32)], -1)
    bear = (bear / np.linalg.norm(bear, axis=-1, keepdims=True)).astype(np.float32)
    jr, js = jpnp.bearing_tangent_basis(jnp.asarray(bear))
    tr, ts = tpnp.bearing_tangent_basis(T(bear))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    B = 3
    dR = [np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.03, 3), jnp.float32)))
          for _ in range(B)]
    R0 = np.stack([d @ R for d in dR]).astype(np.float32)
    t0 = (t + rng.normal(0, 0.1, (B, 3))).astype(np.float32)
    w = (rng.uniform(size=(B, len(X))) > 0.2).astype(np.float32) * 9e4
    jR, jt = jax.vmap(lambda a, b, c: jpnp._mlpnp_gn(a, b, jnp.asarray(X), jr, js, c))(
        jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(w))
    tR, tt = tpnp.mlpnp_gn(T(R0), T(t0), T(X), tr, ts, T(w))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_allclose(tR.numpy()[0], R, atol=1e-2)


@pytest.mark.parametrize("seed", [1, 2])
def test_extract_rt(seed):
    rng = np.random.default_rng(seed)
    R = np.stack([np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.5, 3), jnp.float32)))
                  for _ in range(8)])
    P = np.concatenate([R * rng.uniform(0.5, 2, (8, 1, 1)), rng.normal(0, 1, (8, 3, 1))],
                       -1).astype(np.float32)
    P += rng.normal(0, 0.01, P.shape).astype(np.float32)
    jR, jt = jpnp._extract_rt(jnp.asarray(P))
    tR, tt = tpnp._extract_rt(T(P))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("outlier_frac", [0.0, 0.15, 0.3])
def test_pnp_ransac_same_samples(outlier_frac, seed):
    rng = np.random.default_rng(seed)
    cam, X, uv, R, t, _ = make_problem(rng, n=200, outlier_frac=outlier_frac, noise=0.5)
    n = len(X)
    valid = np.ones(n, bool)
    valid[::11] = False
    inv_s2 = np.ones(n, np.float32)
    key = jax.random.PRNGKey(0)
    j = jpnp.pnp_ransac(key, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid),
                        jnp.asarray(inv_s2), cam)
    idx = jax.random.categorical(key, jnp.where(jnp.asarray(valid), 0.0, -1e9)[None],
                                 shape=(256, 6))
    tcam = TCamera.pinhole(cam.fx, cam.fy, cam.cx, cam.cy)
    res = tpnp.pnp_from_samples(T(idx, torch.int64), T(X), T(uv), T(valid), T(inv_s2),
                                tcam)
    assert bool(res.success) and bool(j.success)
    assert abs(int(res.n_inliers) - int(j.n_inliers)) <= 1
    np.testing.assert_allclose(res.R.numpy(), np.asarray(j.R), atol=1e-3)
    np.testing.assert_allclose(res.t.numpy(), np.asarray(j.t), atol=1e-2)
    np.testing.assert_allclose(res.R.numpy(), R, atol=1e-3)
    np.testing.assert_allclose(res.t.numpy(), t, atol=1e-2)


@pytest.mark.parametrize("n_valid", [0, 1, 37])
def test_sample_draws_valid_slots(n_valid):
    """The sampler draws only valid slots (all slots when none is valid, as
    a categorical over equal logits does), roughly uniformly."""
    valid = torch.zeros(120, dtype=torch.bool)
    valid[torch.randperm(120, generator=torch.Generator().manual_seed(0))[:n_valid]] = True
    idx = tsim3.sample(torch.Generator().manual_seed(1), valid, 1500, 3)
    assert idx.shape == (1500, 3) and idx.dtype == torch.int64
    allowed = valid if n_valid else torch.ones_like(valid)
    assert bool(allowed[idx].all())
    counts = torch.bincount(idx.reshape(-1), minlength=120)[allowed].float()
    assert counts.min() > 0.3 * counts.mean()


def test_dlt_sign_normalised():
    """The reference keeps the eigensolver's sign of each DLT solution, so
    a share of its hypotheses come out mirrored; the port's all have
    det(P[:, :3]) > 0. (The null vectors themselves are not compared: the
    6-point normal matrix is too ill-conditioned in float32 for two
    eigensolvers to agree hypothesis by hypothesis.)"""
    rng = np.random.default_rng(3)
    cam, X, uv, _, _, _ = make_problem(rng, n=200, noise=0.5)
    idx = np.asarray(jax.random.categorical(jax.random.PRNGKey(0), jnp.zeros((1, 200)),
                                            shape=(256, 6)))
    xn = np.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], -1)
    jP = np.asarray(jpnp._dlt_p(jnp.asarray(X[idx]), jnp.asarray(xn[idx])))
    tP = tpnp._dlt_p(T(X[idx]), T(xn[idx])).numpy()
    neg = np.linalg.det(jP[:, :, :3]) < 0
    print(f"reference DLT solutions with det(P[:, :3]) < 0: {neg.mean():.3f}")
    assert 0.2 < neg.mean() < 0.8
    assert (np.linalg.det(tP[:, :, :3]) > 0).all()
