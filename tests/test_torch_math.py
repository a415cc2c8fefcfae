"""Parity of the port's math substrate (lie, linalg, cameras) with the JAX
package, on the same numpy inputs.

Tolerance: rtol/atol 1e-5 — both sides compute in float32 with the same
closed forms; only operation order and fused multiply-adds differ, which
moves results by a few ulps of O(1) values.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_vio_fixes_tpu.ops import triangulate as jtri
from orb_slam3_vio_fixes_tpu.utils import cameras as jcam
from orb_slam3_vio_fixes_tpu.utils import lie as jlie
from orb_slam3_vio_fixes_tpu.utils import linalg as jlinalg
from orb_slam3_vio_fixes_tpu_torch import convert
from orb_slam3_vio_fixes_tpu_torch.ops import triangulate as ttri
from orb_slam3_vio_fixes_tpu_torch.utils import cameras as tcam
from orb_slam3_vio_fixes_tpu_torch.utils import lie as tlie
from orb_slam3_vio_fixes_tpu_torch.utils import linalg as tlinalg

torch.set_num_threads(2)


TOL = dict(rtol=1e-5, atol=1e-5)


def j2n(x):
    return np.array(x)


def t2n(x):
    return x.detach().cpu().numpy()


def rand_rot(rng, n, scale=1.0):
    return rng.normal(0, scale, (n, 3)).astype(np.float32)


def _angles(rng):
    """Generic angles plus small (Taylor branch) and near-pi ones."""
    w = rand_rot(rng, 64)
    small = rand_rot(rng, 8, 1e-5)
    axis = rand_rot(rng, 8)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    near_pi = (axis * (np.pi - 1e-3)).astype(np.float32)
    return np.concatenate([w, small, near_pi])


LIE_UNARY = ["hat", "so3_exp", "so3_left_jacobian", "so3_right_jacobian",
             "so3_right_jacobian_inv"]


@pytest.mark.parametrize("name", LIE_UNARY)
def test_lie_unary(rng, name):
    w = _angles(rng)
    np.testing.assert_allclose(t2n(getattr(tlie, name)(torch.from_numpy(w))),
                               j2n(getattr(jlie, name)(jnp.asarray(w))), **TOL)


def test_so3_log_and_vee(rng):
    w = _angles(rng)
    R = j2n(jlie.so3_exp(jnp.asarray(w)))
    np.testing.assert_allclose(t2n(tlie.so3_log(torch.from_numpy(R))),
                               j2n(jlie.so3_log(jnp.asarray(R))), rtol=1e-5,
                               atol=2e-5)
    W = j2n(jlie.hat(jnp.asarray(w)))
    np.testing.assert_allclose(t2n(tlie.vee(torch.from_numpy(W))), w, **TOL)


def test_so3_normalize(rng):
    """Near-rotations (composition drift up to 1e-3): Newton's polar factor
    equals the reference's SVD projection."""
    R = j2n(jlie.so3_exp(jnp.asarray(rand_rot(rng, 32))))
    R = (R + rng.normal(0, 1e-3, R.shape)).astype(np.float32)
    np.testing.assert_allclose(t2n(tlie.so3_normalize(torch.from_numpy(R))),
                               j2n(jlie.so3_normalize(jnp.asarray(R))), **TOL)


def test_se3_exp_log_compose(rng):
    xi = np.concatenate([rng.normal(0, 1, (32, 3)), rand_rot(rng, 32)],
                        axis=1).astype(np.float32)
    Rj, tj = jlie.se3_exp(jnp.asarray(xi))
    Rt, tt = tlie.se3_exp(torch.from_numpy(xi))
    np.testing.assert_allclose(t2n(Rt), j2n(Rj), **TOL)
    np.testing.assert_allclose(t2n(tt), j2n(tj), **TOL)
    R, t = j2n(Rj), j2n(tj)
    np.testing.assert_allclose(
        t2n(tlie.se3_log(torch.from_numpy(R), torch.from_numpy(t))),
        j2n(jlie.se3_log(jnp.asarray(R), jnp.asarray(t))), rtol=1e-5, atol=2e-5)
    Ra, ta = torch.from_numpy(R), torch.from_numpy(t)
    for tf, jf in ((tlie.se3_compose(Ra, ta, Ra.flip(0), ta.flip(0)),
                    jlie.se3_compose(R, t, R[::-1], t[::-1])),
                   (tlie.se3_inverse(Ra, ta), jlie.se3_inverse(R, t))):
        for a, b in zip(tf, jf):
            np.testing.assert_allclose(t2n(a), j2n(b), **TOL)
    np.testing.assert_allclose(t2n(tlie.se3_apply(Ra, ta, ta.flip(0))),
                               j2n(jlie.se3_apply(R, t, t[::-1])), **TOL)


def test_sim3_and_quaternions(rng):
    xi = np.concatenate([rng.normal(0, 1, (16, 3)), rand_rot(rng, 16),
                         rng.normal(0, 0.3, (16, 1))], axis=1).astype(np.float32)
    xi[:4, 6] = 0.0                 # near-zero sigma branch
    for a, b in zip(tlie.sim3_exp(torch.from_numpy(xi)), jlie.sim3_exp(jnp.asarray(xi))):
        np.testing.assert_allclose(t2n(a), j2n(b), rtol=1e-5, atol=2e-5)
    R, t, s = (j2n(v) for v in jlie.sim3_exp(jnp.asarray(xi)))
    np.testing.assert_allclose(
        t2n(tlie.sim3_log(*(torch.from_numpy(v) for v in (R, t, s)))),
        j2n(jlie.sim3_log(R, t, s)), rtol=1e-4, atol=1e-4)
    Rt, tt, st = (torch.from_numpy(v) for v in (R, t, s))
    p = rng.normal(0, 2, (16, 3)).astype(np.float32)
    np.testing.assert_allclose(t2n(tlie.sim3_apply(Rt, tt, st, torch.from_numpy(p))),
                               j2n(jlie.sim3_apply(R, t, s, p)), **TOL)
    for tf, jf in ((tlie.sim3_inverse(Rt, tt, st), jlie.sim3_inverse(R, t, s)),
                   (tlie.sim3_compose(Rt, tt, st, Rt.flip(0), tt.flip(0), st.flip(0)),
                    jlie.sim3_compose(R, t, s, R[::-1], t[::-1], s[::-1]))):
        for a, b in zip(tf, jf):
            np.testing.assert_allclose(t2n(a), j2n(b), **TOL)
    q = j2n(jlie.rotmat_to_quat(jnp.asarray(R)))
    np.testing.assert_allclose(t2n(tlie.rotmat_to_quat(torch.from_numpy(R))), q, **TOL)
    np.testing.assert_allclose(t2n(tlie.quat_to_rotmat(torch.from_numpy(q))),
                               j2n(jlie.quat_to_rotmat(jnp.asarray(q))), **TOL)


def _spd(rng, n, d):
    A = rng.normal(0, 1, (n, d, d))
    return (A @ A.transpose(0, 2, 1) + d * np.eye(d)).astype(np.float32)


def test_linalg_closed_forms(rng):
    A3 = _spd(rng, 32, 3)
    np.testing.assert_allclose(t2n(tlinalg.inv3(torch.from_numpy(A3))),
                               j2n(jlinalg.inv3(jnp.asarray(A3))), **TOL)
    A6 = _spd(rng, 32, 6)
    b = rng.normal(0, 1, (32, 6)).astype(np.float32)
    np.testing.assert_allclose(
        t2n(tlinalg.solve6(torch.from_numpy(A6), torch.from_numpy(b))),
        j2n(jlinalg.solve6(jnp.asarray(A6), jnp.asarray(b))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t2n(tlinalg.inv6(torch.from_numpy(A6))),
                               j2n(jlinalg.inv6(jnp.asarray(A6))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("budget", [5, 40, 300])
def test_compact_indices(rng, budget):
    """Exact: an integer compaction."""
    mask = rng.random(200) < 0.3
    ij, fj = jlinalg.compact_indices(jnp.asarray(mask), budget)
    it, ft = tlinalg.compact_indices(torch.from_numpy(mask), budget)
    np.testing.assert_array_equal(t2n(it), j2n(ij))
    np.testing.assert_array_equal(t2n(ft), j2n(fj))


@pytest.mark.parametrize("keep", ["nonzero", "mask"])
def test_index_add_rows(rng, keep):
    """Exact on the CPU: the kept rows add as index_add_ adds them (the same
    order per index); rows of zeros, or rows outside the mask, go to dump
    rows of their own (the padding of a fixed-capacity factor list, which
    shares one index, would otherwise serialise CUDA's deterministic
    index_add_)."""
    m, n = 500, 40
    idx = torch.from_numpy(rng.integers(0, n, m))
    vals = torch.from_numpy(rng.normal(size=(m, 3, 3)).astype(np.float32))
    pad = torch.from_numpy(rng.random(m) < 0.6)
    idx = torch.where(pad, torch.zeros_like(idx), idx)     # padding on row 0
    vals = torch.where(pad[:, None, None], torch.zeros_like(vals), vals)
    ref = torch.zeros((n, 3, 3)).index_add_(0, idx, vals)
    out = torch.full((n, 3, 3), 7.0).zero_()
    got = tlinalg.index_add_rows(out, idx, vals, None if keep == "nonzero" else ~pad)
    assert got is out and torch.equal(got, ref)
    dumps = tlinalg.spread_dumps(idx, ~pad, n)
    assert torch.equal(dumps[~pad], idx[~pad]) and dumps[pad].unique().numel() == int(pad.sum())


CAMS = {
    "pinhole": ((458.0, 457.0, 367.2, 248.4), None),
    "kb8": ((190.0, 190.5, 254.9, 256.9), (0.0034, 0.0007, -0.0024, 0.0004)),
}


def _cams(kind):
    (fx, fy, cx, cy), dist = CAMS[kind]
    if dist is None:
        return jcam.Camera.pinhole(fx, fy, cx, cy), tcam.Camera.pinhole(fx, fy, cx, cy)
    return jcam.Camera.kb8(fx, fy, cx, cy, *dist), tcam.Camera.kb8(fx, fy, cx, cy, *dist)


@pytest.mark.parametrize("kind", sorted(CAMS))
def test_camera_models(rng, kind):
    jc, tc = _cams(kind)
    pc = np.stack([rng.uniform(-2, 2, 64), rng.uniform(-2, 2, 64),
                   rng.uniform(1, 8, 64)], axis=1).astype(np.float32)
    pt = torch.from_numpy(pc)
    uv = j2n(jcam.project(jc, jnp.asarray(pc)))
    np.testing.assert_allclose(t2n(tcam.project(tc, pt)), uv, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(t2n(tcam.unproject(tc, torch.from_numpy(uv))),
                               j2n(jcam.unproject(jc, jnp.asarray(uv))), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(t2n(tcam.project_jac(tc, pt)),
                               j2n(jcam.project_jac(jc, jnp.asarray(pc))), rtol=1e-5,
                               atol=1e-3)
    bf = 50.3
    np.testing.assert_allclose(t2n(tcam.stereo_project(tc, bf, pt)),
                               j2n(jcam.stereo_project(jc, jnp.float32(bf), jnp.asarray(pc))),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(t2n(tcam.in_image(torch.from_numpy(uv), 500, 400, 2.0)),
                                  j2n(jcam.in_image(jnp.asarray(uv), 500, 400, 2.0)))
    # the JAX camera's leaves carried across give the port's camera exactly
    assert convert.camera_from_numpy(*(j2n(v) for v in jc[:5]), jc.kind) == tc


def test_triangulation_primitives(rng):
    """Two-view DLT and ray midpoint on noisy rays at 2-8 m with a ~0.4 m
    baseline, and stereo back-projection. Tolerance rtol 2e-3 for the two
    triangulations: at a few degrees of parallax both solve systems whose
    determinant cancels in float32 (it scales with sin^2 of the parallax), so
    operation order alone moves the point by up to ~1e-3 relative; stereo
    back-projection is one division per point, rtol 1e-5."""
    n = 64
    R1, R2 = (j2n(jlie.so3_exp(jnp.asarray(rand_rot(rng, n, 0.1)))) for _ in range(2))
    t1 = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    t2 = (t1 + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(2, 8, n)],
                 axis=1).astype(np.float32)

    def ray(R, t):
        p = np.einsum("nij,nj->ni", R, X) + t
        return (p / p[:, 2:] + rng.normal(0, 1e-3, p.shape) * [1, 1, 0]).astype(np.float32)

    args = (R1, t1, R2, t2, ray(R1, t1), ray(R2, t2))
    for name in ("triangulate_dlt", "triangulate_midpoint"):
        np.testing.assert_allclose(
            t2n(getattr(ttri, name)(*(torch.from_numpy(v) for v in args))),
            j2n(getattr(jtri, name)(*(jnp.asarray(v) for v in args))), rtol=2e-3,
            atol=1e-5)
    jc, tc = _cams("pinhole")
    uv = rng.uniform(0, 700, (n, 2)).astype(np.float32)
    ur = (uv[:, 0] - rng.uniform(0.5, 60, n)).astype(np.float32)
    for a, b in zip(ttri.stereo_backproject(tc, 50.3, torch.from_numpy(uv),
                                            torch.from_numpy(ur)),
                    jtri.stereo_backproject(jc, jnp.float32(50.3), jnp.asarray(uv),
                                            jnp.asarray(ur))):
        np.testing.assert_allclose(t2n(a), j2n(b), **TOL)
