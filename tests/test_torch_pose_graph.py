"""The port's pose-graph optimiser (optim/pose_graph.py) against the JAX
package's on tests/test_pose_graph.py's drifted circle: 7-DoF Sim3,
fixed-scale SE3 and the inertial 4-DoF mode, with a loop edge carrying the
true relative pose (and, for 7-DoF, a scale); and the essential-edge
assembly from a map snapshot.

Tolerances: edge residuals and Jacobians within 1e-4 (float32 Sim3 log and
forward-mode autodiff on both sides); optimised poses within 1e-3 and
scales within 1e-3 (ten LM steps of a float32 Cholesky on a 168x168
system); per-step costs within 1e-3 relative; essential edges exact (index
lists) and within 1e-6 (measurements).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu.optim import pose_graph as jpg
from orb_slam3_vio_fixes_tpu_torch import convert
from orb_slam3_vio_fixes_tpu_torch.optim import pose_graph as tpg

from test_pose_graph import _circle_gt, _drifted, _pose_err

torch.set_num_threads(2)


def T(a):
    return torch.as_tensor(np.array(a))


def _graphs(K=24, loop_scale=1.0):
    """(R0, t0, R_gt, t_gt, JAX edges, port edges): drifted chain + loop."""
    R_gt, t_gt = _circle_gt(K)
    R0, t0 = _drifted(R_gt, t_gt)
    je = jpg.PoseGraphEdges.empty(64)
    te = tpg.PoseGraphEdges.empty(64, "cpu")
    one = jnp.float32(1.0)
    for k in range(1, K + 1):
        if k < K:
            i, j, (Ra, ta), (Rb, tb), w = k - 1, k, (R0[k], t0[k]), (R0[k - 1], t0[k - 1]), 1.0
        else:
            i, j, (Ra, ta), (Rb, tb), w = 0, K - 1, (R_gt[K - 1], t_gt[K - 1]), \
                (R_gt[0], t_gt[0]), 100.0
        Rm, tm, sm = jpg.relative_sim3(jnp.asarray(Ra), jnp.asarray(ta), one,
                                       jnp.asarray(Rb), jnp.asarray(tb), one)
        if k == K:
            sm = sm * loop_scale
        je = jpg.add_loop_edge(je, k - 1, i, j, Rm, tm, sm, weight=w)
        tpg.add_loop_edge(te, k - 1, i, j, T(Rm), T(tm), T(sm), weight=w)
    return R0, t0, R_gt, t_gt, je, te


MODES = {"sim3": dict(), "se3": dict(fix_scale=True), "four_dof": dict(four_dof=True,
                                                                        fix_scale=True)}


@pytest.mark.parametrize("K", [8, 24])
def test_edge_residuals_and_jacobians(K):
    R0, t0, _, _, je, te = _graphs(K)
    ii, jj = np.asarray(je.idx_i), np.asarray(je.idx_j)
    s = np.ones(len(R0), np.float32)
    jargs = [jnp.asarray(a) for a in (R0[ii], t0[ii], s[ii], R0[jj], t0[jj], s[jj])] + \
        [je.R_ji, je.t_ji, je.s_ji]
    jres, (jJi, jJj) = jpg._res_and_jac(*jargs)
    tres, tJi, tJj = tpg._res_and_jac(*[T(a) for a in jargs])
    for a, b in ((tres, jres), (tJi, jJi), (tJj, jJj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


@pytest.mark.parametrize("K", [12, 24])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_optimize_pose_graph(mode, K):
    R0, t0, R_gt, t_gt, je, te = _graphs(K, loop_scale=1.1 if mode == "sim3" else 1.0)
    K = len(R0)
    cfg = dict(n_iters=10, **MODES[mode])
    fixed = np.zeros(K, bool)
    fixed[0] = True
    jR, jt, js, jchi = jpg.optimize_pose_graph(
        jnp.asarray(R0), jnp.asarray(t0), jnp.ones(K), jnp.asarray(fixed), je,
        jpg.PoseGraphConfig(**cfg))
    tR, tt, ts, tchi = tpg.optimize_pose_graph(
        T(R0), T(t0), torch.ones(K), T(fixed), te, tpg.PoseGraphConfig(**cfg))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-3)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-3)
    np.testing.assert_allclose(tchi.numpy(), np.asarray(jchi), rtol=1e-3)
    np.testing.assert_array_equal(tR[0].numpy(), R0[0])
    if mode != "sim3" and K == 24:    # test_pose_graph's scenario and bar
        assert _pose_err(tR.numpy(), tt.numpy(), R_gt, t_gt) < \
            0.5 * _pose_err(R0, t0, R_gt, t_gt)
    if mode == "four_dof":
        # only the yaw tangent moves: each update is a rotation about z
        np.testing.assert_allclose((tR.numpy() @ R0.transpose(0, 2, 1))[:, 2, 2], 1.0,
                                   atol=1e-4)


@pytest.mark.parametrize("seed", [2, 7])
def test_essential_edges_from_map(seed):
    rng = np.random.default_rng(seed)
    K = 12
    R_gt, t_gt = _circle_gt(K)
    valid = np.ones(K, bool)
    valid[[3, 8]] = False
    prev = np.arange(-1, K - 1).astype(np.int32)
    cov = rng.integers(0, 200, (K, K))
    cov = np.triu(cov, 1) + np.triu(cov, 1).T
    je = jpg.essential_edges_from_map(R_gt, t_gt, valid, prev, cov, 64)
    te = tpg.essential_edges_from_map(R_gt, t_gt, valid, prev, cov, 64, device="cpu")
    for f in ("idx_i", "idx_j", "valid", "weight"):
        np.testing.assert_array_equal(getattr(te, f).numpy(), np.asarray(getattr(je, f)),
                                      err_msg=f)
    for f in ("R_ji", "t_ji", "s_ji"):
        np.testing.assert_allclose(getattr(te, f).numpy(), np.asarray(getattr(je, f)),
                                   atol=1e-6, err_msg=f)
    assert int(te.valid.sum()) > K
    tc = convert.pose_graph_edges_from_numpy({f: np.asarray(getattr(je, f))
                                              for f in je._fields}, "cpu")
    for f in te._fields:
        assert getattr(tc, f).dtype == getattr(te, f).dtype, f
        np.testing.assert_allclose(getattr(tc, f).numpy(), getattr(te, f).numpy(),
                                   atol=1e-6, err_msg=f)


def test_relative_sim3():
    rng = np.random.default_rng(4)
    R_gt, t_gt = _circle_gt(6)
    s = rng.uniform(0.8, 1.2, 6).astype(np.float32)
    args = (R_gt[:3], t_gt[:3], s[:3], R_gt[3:], t_gt[3:], s[3:])
    j = jax.vmap(jpg.relative_sim3)(*map(jnp.asarray, args))
    t = tpg.relative_sim3(*map(T, args))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
