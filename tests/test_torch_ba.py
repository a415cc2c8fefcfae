"""Parity of the port's LM solvers with the JAX package on the
tests/test_ba.py scenes: motion-only pose_optimize and bundle_adjust on the
dense-struct / PCG path that local BA uses.

Tolerances: R within 1e-4 and t within 1e-3 (float32 LM: ~10-40 steps of
sums taken in another order; the chi2 gates see the same residuals to
~1e-6), inlier masks identical.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_vio_fixes_tpu.optim import ba_core as jba
from orb_slam3_vio_fixes_tpu.utils import lie as jlie
from orb_slam3_vio_fixes_tpu.utils.cameras import project as jproject
from orb_slam3_vio_fixes_tpu_torch.optim import ba_core as tba
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera as TCamera

from test_ba import BF, CAM, make_scene, perturb

torch.set_num_threads(2)


TCAM = TCamera.pinhole(458.0, 457.0, 320.0, 240.0)
TBF = float(np.float32(BF))


def t(x):
    return torch.from_numpy(np.array(x))


def _port_problem(p: jba.BAProblem) -> tba.BAProblem:
    f = p.factors
    return tba.BAProblem(
        R=t(p.R), t=t(p.t), pose_fixed=t(p.pose_fixed), lm=t(p.lm),
        lm_valid=t(p.lm_valid), lm_fixed=t(p.lm_fixed),
        factors=tba.ReprojFactors(t(f.pose_idx).long(), t(f.lm_idx).long(),
                                  t(f.uvr), t(f.inv_sigma2), t(f.valid)),
        cam=TCAM, bf=TBF)


def _ba_problem(rng, outliers: bool):
    R_gt, t_gt, pts, factors, _ = make_scene(
        rng, noise_px=0.2 if outliers else 0.0, outlier_frac=0.1 if outliers else 0.0)
    R0, t0 = perturb(rng, R_gt, t_gt, 0.01, 0.02)
    R0[0], t0[0] = R_gt[0], t_gt[0]
    return jba.BAProblem(
        R=jnp.asarray(R0), t=jnp.asarray(t0),
        pose_fixed=jnp.zeros(6, bool).at[0].set(True),
        lm=jnp.asarray(pts + rng.normal(0, 0.03, pts.shape).astype(np.float32)),
        lm_valid=jnp.ones(pts.shape[0], bool),
        lm_fixed=jnp.zeros(pts.shape[0], bool).at[:5].set(True),
        factors=factors, cam=CAM, bf=BF)


def test_residuals_and_jacobians(rng):
    p = _ba_problem(rng, outliers=True)
    ref = jax.jit(jba.reproj_jacobians)(p)
    got = tba.reproj_jacobians(_port_problem(p))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("outliers", [False, True])
def test_bundle_adjust_local_ba_path(rng, outliers):
    p = _ba_problem(rng, outliers)
    jcfg = jba.LMConfig(n_rounds=2, n_iters=3, cg_iters=12)
    tcfg = tba.LMConfig(n_rounds=2, n_iters=3, cg_iters=12)
    jout, jin, _ = jba.bundle_adjust(p, jcfg)
    tout, tin, _ = tba.bundle_adjust(_port_problem(p), tcfg)
    np.testing.assert_allclose(tout.R.numpy(), np.asarray(jout.R), atol=1e-4)
    np.testing.assert_allclose(tout.t.numpy(), np.asarray(jout.t), atol=1e-3)
    np.testing.assert_allclose(tout.lm.numpy(), np.asarray(jout.lm), atol=1e-3)
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))


def test_pose_optimize(rng):
    """The tests/test_ba.py pose case (15 gross outliers, LMConfig()'s 4 x 10
    schedule; the tracker's 2 x 5 runs in test_torch_slice), with mono rows,
    octave weights and invalid rows added."""
    rounds, iters = 4, 10
    pts = rng.uniform(-4, 4, size=(120, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(6, 14, 120)
    w = rng.normal(0, 0.1, 3).astype(np.float32)
    R_gt = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    t_gt = np.array([0.3, -0.2, 0.1], np.float32)
    Xc = pts @ R_gt.T + t_gt
    uv = np.array(jproject(CAM, jnp.asarray(Xc)))
    ur = uv[:, 0] - np.asarray(BF) / Xc[:, 2]
    uvr = np.concatenate([uv + rng.normal(0, 0.3, uv.shape), ur[:, None]],
                         axis=1).astype(np.float32)
    uvr[:15, :2] += 40.0
    uvr[100:, 2] = -1.0            # some mono rows
    R0 = np.asarray(jlie.so3_exp(jnp.asarray(w + rng.normal(0, 0.02, 3).astype(np.float32))))
    t0 = (t_gt + rng.normal(0, 0.05, 3)).astype(np.float32)
    inv_s2 = (1.0 / 1.44 ** rng.integers(0, 3, 120)).astype(np.float32)
    valid = rng.random(120) < 0.95
    ref = jba.pose_optimize(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(pts),
                            jnp.asarray(uvr), jnp.asarray(inv_s2), jnp.asarray(valid),
                            CAM, BF, jba.LMConfig(n_rounds=rounds, n_iters=iters))
    got = tba.pose_optimize(t(R0), t(t0), t(pts), t(uvr), t(inv_s2), t(valid), TCAM,
                            TBF, tba.LMConfig(n_rounds=rounds, n_iters=iters))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-3)
    np.testing.assert_array_equal(got.inlier.numpy(), np.asarray(ref.inlier))
    assert int(got.n_inliers) == int(ref.n_inliers) > 90
