"""The port's multi-device layer (orb_slam3_vio_fixes_tpu_torch/parallel/ and
optim/vi_global_ba.run_global_vi_ba_sharded) against the JAX package's on
the conftest's 8 virtual CPU devices; the port runs on Mesh(["cpu"] * 8).

Tolerances: partition layouts, sharded-match winners and distances exact
(integer reductions on the same inputs); the sharded BA and VI BA within
the JAX package's own bars against its single-device solvers
(tests/test_sharded_ba.py, test_global_ba.py, test_vi_global_ba.py:
camera centres within 1e-2 m of the truth, keyframe positions within 2e-3
m, relative-rotation traces above 3 - 1e-4, the landmark median within
1e-3 m, inlier counts within 2%), held both against JAX's sharded results
and against the port's unsharded ones; two runs of one sharded solve
identical bytes (every reduction in shard order on one device).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from orb_slam3_vio_fixes_tpu.ops import matching as jmatching
from orb_slam3_vio_fixes_tpu.optim import ba_core as jba
from orb_slam3_vio_fixes_tpu.optim import vi_global_ba as jvg
from orb_slam3_vio_fixes_tpu.parallel import sharded_ba as jsba
from orb_slam3_vio_fixes_tpu.parallel import sharded_matching as jsm
from orb_slam3_vio_fixes_tpu.utils import lie as jlie
from orb_slam3_vio_fixes_tpu_torch import convert, kernels
from orb_slam3_vio_fixes_tpu_torch.optim import ba_core as tba
from orb_slam3_vio_fixes_tpu_torch.optim import global_ba as tgba
from orb_slam3_vio_fixes_tpu_torch.optim import vi_ba as tvi
from orb_slam3_vio_fixes_tpu_torch.optim import vi_global_ba as tvg
from orb_slam3_vio_fixes_tpu_torch.parallel import Mesh, P, shard_map
from orb_slam3_vio_fixes_tpu_torch.parallel import sharded_ba as tsba
from orb_slam3_vio_fixes_tpu_torch.parallel import sharded_matching as tsm
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera as TCamera

import test_global_ba
import test_vi_global_ba
from test_ba import BF, CAM, make_scene, perturb

torch.set_num_threads(2)

N_DEV = 8
TCAM = TCamera.pinhole(CAM.fx, CAM.fy, CAM.cx, CAM.cy)


@pytest.fixture(scope="module")
def jmesh():
    def make(axis):
        assert jax.device_count() >= N_DEV, "conftest must provide 8 virtual CPU devices"
        return JMesh(np.array(jax.devices()[:N_DEV]), (axis,))
    return make


def tmesh(axis="lm"):
    return Mesh(["cpu"] * N_DEV, (axis,))


def T(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def leaves(nt) -> dict:
    return {k: np.array(v) for k, v in nt._asdict().items()}


# -- the mesh itself --

def test_collectives_in_shard_order_and_counts():
    """psum sums the partials in shard order (a left fold, the same bytes
    on every shard), pmin takes the minimum, axis_index numbers the shards,
    P(axis) results concatenate in shard order, each shard's launch counts."""
    mesh = tmesh()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(16, 3)).astype(np.float32))

    def body(ax, xl):
        kernels.count("hamming_match_cols")
        return ax.psum(xl.sum(0)), ax.pmin(xl.min(0).values), xl + ax.axis_index

    before = kernels.launch_counts()["hamming_match_cols"]
    s, m, y = shard_map(body, mesh, (P("lm"),), (P(), P(), P("lm")))(x)
    assert kernels.launch_counts()["hamming_match_cols"] - before == N_DEV
    parts = x.reshape(N_DEV, 2, 3).sum(1)
    fold = parts[0].clone()
    for p in parts[1:]:
        fold = fold + p
    assert torch.equal(s, fold)
    assert torch.equal(m, x.min(0).values)
    assert torch.equal(y, x + torch.arange(N_DEV).repeat_interleave(2)[:, None])
    assert Mesh(["cpu"] * 4, "db").shape == {"db": 4}


def test_launch_counts_lose_nothing_under_threads():
    """kernels.count from more threads than cores, the interpreter switching
    threads every microsecond: no increment is lost."""
    import sys

    before = kernels.launch_counts()["hamming_match_cols"]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [kernels.count("hamming_match_cols")
                                                    for _ in range(2000)])
                   for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert kernels.launch_counts()["hamming_match_cols"] - before == 32 * 2000


def test_failing_shard_raises_without_hanging():
    """A shard that raises while the others wait in a collective ends every
    shard's turn: the caller gets the shard's own exception within 10 s; a
    shard that returns while the others still reduce raises too."""
    def fails(ax, x):
        if ax.axis_index == 5:
            raise KeyError("shard 5")
        return (ax.psum(x),)

    def returns_early(ax, x):
        if ax.axis_index == 2:
            return (x,)
        return (ax.psum(x),)

    got = {}

    def call(name, body):
        try:
            shard_map(body, tmesh(), (P(),), (P(),))(torch.ones(3))
        except Exception as e:      # noqa: BLE001
            got[name] = e

    threads = [threading.Thread(target=call, args=a, daemon=True)
               for a in (("fails", fails), ("early", returns_early))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads), "a shard failure hung the mesh"
    assert isinstance(got["fails"], KeyError)
    assert isinstance(got["early"], RuntimeError) and "disagree" in str(got["early"])


# -- sharded matching: tests/test_sharded_matching.py's inputs --

def _match_inputs(case):
    if case == "parity":
        rng = np.random.default_rng(0)
        Q, D = 64, 1000
        q = rng.integers(0, 2**32, (Q, 8), dtype=np.uint32)
        db = rng.integers(0, 2**32, (D, 8), dtype=np.uint32)
        rows = rng.choice(D, Q // 2, replace=False)
        db[rows] = q[: Q // 2]
        qv = np.ones(Q, bool)
        qv[-3:] = False
        dv = np.ones(D, bool)
        dv[5] = False
    elif case == "ragged":
        rng = np.random.default_rng(3)
        Q, D = 48, 8 * 137 + 5
        q = rng.integers(0, 2**32, (Q, 8), dtype=np.uint32)
        db = rng.integers(0, 2**32, (D, 8), dtype=np.uint32)
        for k in range(16):
            a, b = k * 30, 950 + k * 9
            db[a] = q[k]
            db[b] = q[k]
            db[b, 0] ^= 0x3
        qv, dv = np.ones(Q, bool), np.ones(D, bool)
    else:   # ratio: an exact unique match and an identical cross-shard twin
        rng = np.random.default_rng(4)
        N, L = 32, 8 * 64
        q = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
        db = rng.integers(0, 2**32, (L, 8), dtype=np.uint32)
        db[3] = q[0]
        db[10] = q[1]
        db[L - 5] = q[1]
        qv, dv = np.ones(N, bool), np.ones(L, bool)
    return q, qv, db, dv


@pytest.mark.parametrize("case", ["parity", "ragged", "ratio"])
def test_sharded_match_equals_reference(case, jmesh):
    q, qv, db, dv = _match_inputs(case)
    jdb, jdv = jsm.pad_database(db, dv, N_DEV)
    tdb, tdv = tsm.pad_database(db, dv, N_DEV)
    np.testing.assert_array_equal(tdb.numpy().view(np.uint32), np.asarray(jdb))
    np.testing.assert_array_equal(tdv.numpy(), np.asarray(jdv))
    tq = torch.from_numpy(q.view(np.int32))
    tqv = torch.from_numpy(qv)
    if case == "ratio":
        mesh = jmesh("db")
        jids = np.asarray(jsm.sharded_global_bind(jnp.asarray(q), jnp.asarray(qv), jdb, jdv,
                                                  mesh))
        tids = tsm.sharded_global_bind(tq, tqv, tdb, tdv, tmesh("db")).numpy()
        np.testing.assert_array_equal(tids, jids)
        assert tids[0] == 3 and tids[1] == -1
        return
    j = [np.asarray(a) for a in jsm.sharded_match(jnp.asarray(q), jnp.asarray(qv), jdb, jdv,
                                                  jmesh("db"), max_dist=300)]
    t = [a.numpy() for a in tsm.sharded_match(tq, tqv, tdb, tdv, tmesh("db"), max_dist=300)]
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a[qv], b[qv])
    assert (t[0][~qv] == -1).all()
    # and the single-device reference's best / second distances
    dist = np.array(jmatching.hamming_matrix(jnp.asarray(q), jnp.asarray(db)))
    dist[:, ~dv] = 1 << 20
    ref_idx = dist.argmin(1)
    d2 = dist.copy()
    d2[np.arange(len(q)), ref_idx] = 1 << 20
    np.testing.assert_array_equal(t[1][qv], dist.min(1)[qv])
    np.testing.assert_array_equal(t[2][qv], d2.min(1)[qv])


def test_pad_database_index_budget():
    with pytest.raises(ValueError, match="22-bit"):
        tsm.pad_database(np.zeros(((1 << 22) - 1, 8), np.uint32),
                         np.ones((1 << 22) - 1, bool), 8)


# -- landmark-sharded BA: tests/test_sharded_ba.py's scene --

def _ba_problems(seed, n_poses=4, n_points=48):
    rng = np.random.default_rng(seed)
    R_gt, t_gt, pts, factors, _ = make_scene(rng, n_poses=n_poses, n_points=n_points,
                                             noise_px=0.0)
    R0, t0 = perturb(rng, R_gt, t_gt, 0.01, 0.03)
    R0[0], t0[0] = R_gt[0], t_gt[0]
    lm0 = pts + rng.normal(0, 0.03, pts.shape).astype(np.float32)
    fixed = np.zeros(n_poses, bool)
    fixed[0] = True
    jp = jba.BAProblem(R=jnp.asarray(R0), t=jnp.asarray(t0), pose_fixed=jnp.asarray(fixed),
                       lm=jnp.asarray(lm0), lm_valid=jnp.ones(n_points, bool),
                       lm_fixed=jnp.zeros(n_points, bool), factors=factors, cam=CAM, bf=BF)
    tf = tba.ReprojFactors(T(factors.pose_idx, torch.int64), T(factors.lm_idx, torch.int64),
                           T(factors.uvr), T(factors.inv_sigma2), T(factors.valid))
    tp = tba.BAProblem(R=T(R0), t=T(t0), pose_fixed=T(fixed), lm=T(lm0),
                       lm_valid=torch.ones(n_points, dtype=torch.bool),
                       lm_fixed=torch.zeros(n_points, dtype=torch.bool), factors=tf,
                       cam=TCAM, bf=float(BF))
    return jp, tp, R_gt, t_gt


def _centres(R, t):
    return -np.einsum("pji,pj->pi", np.asarray(R), np.asarray(t))


@pytest.mark.parametrize("n_shards,n_points", [(8, 50), (3, 50), (8, 48)])
def test_partition_problem_layout(n_shards, n_points):
    jp, tp, *_ = _ba_problems(0, n_points=n_points)
    jpart = jsba.partition_problem(jp, n_shards)
    tpart = tsba.partition_problem(tp, n_shards)
    for name in ("lm", "lm_valid", "lm_fixed"):
        np.testing.assert_array_equal(getattr(tpart, name).numpy(),
                                      np.asarray(getattr(jpart, name)), err_msg=name)
    for name in tba.ReprojFactors._fields:
        np.testing.assert_array_equal(getattr(tpart.factors, name).numpy(),
                                      np.asarray(getattr(jpart.factors, name)), err_msg=name)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_distributed_bundle_adjust(solver, jmesh):
    """Port and JAX sharded solvers on the same partitioned problem; both
    within test_sharded_ba's bars, and the port's within 1e-3 of JAX's."""
    jp, tp, R_gt, t_gt = _ba_problems(1)
    cfg = dict(n_rounds=2, n_iters=5) if solver == "dense" else dict(
        n_rounds=2, n_iters=8, solver="cg", cg_iters=40)
    jout, jinl, _ = jsba.distributed_bundle_adjust(jsba.partition_problem(jp, N_DEV),
                                                   jmesh("lm"), jba.LMConfig(**cfg))
    tpart = tsba.partition_problem(tp, N_DEV)
    tout, tinl, _ = tsba.distributed_bundle_adjust(tpart, tmesh(), tba.LMConfig(**cfg))
    C_gt = _centres(R_gt, t_gt)
    valid = tpart.factors.valid.numpy()
    for R, t, inl in ((tout.R, tout.t, tinl.numpy()), (jout.R, jout.t, np.asarray(jinl))):
        assert np.abs(_centres(R, t) - C_gt).max() < 1e-2
        assert inl[valid].mean() > 0.9
    np.testing.assert_allclose(_centres(tout.R, tout.t), _centres(jout.R, jout.t), atol=1e-3)
    np.testing.assert_allclose(tout.lm.numpy(), np.asarray(jout.lm), atol=1e-3)
    np.testing.assert_array_equal(tinl.numpy()[valid], np.asarray(jinl)[valid])


def _gba_state(seed):
    rng = np.random.default_rng(seed)
    state, R_gt, t_gt, pts = test_global_ba._build_map(rng, L=96)
    noisy = test_global_ba._perturb_map(rng, state)
    fields = {f: np.array(getattr(noisy, f), copy=True) for f in noisy._fields}
    return noisy, fields, R_gt, t_gt, pts


def test_distributed_global_ba(jmesh):
    """test_global_ba.test_distributed_global_ba_matches_single's map: the
    port's sharded GBA within its bars, within 2e-3 m of JAX's sharded
    GBA and of the port's unsharded one; two runs give identical bytes."""
    noisy, fields, R_gt, t_gt, pts = _gba_state(0)
    K, N = noisy.kf_obs.shape
    jout, jn = jsba.distributed_global_ba(noisy, jnp.ones(4, jnp.float32), CAM, BF,
                                          jmesh("lm"), n_levels=4)
    runs = [tsba.distributed_global_ba(convert.map_state_from_numpy(fields, "cpu"),
                                       torch.ones(4), TCAM, float(BF), tmesh(), n_levels=4)
            for _ in range(2)]
    (tout, tn), (tout2, tn2) = runs
    single, sn = tgba.run_global_ba(convert.map_state_from_numpy(fields, "cpu"),
                                    torch.ones(4), TCAM, float(BF), 0, n_levels=4)
    for f in tout._fields:
        a, b = getattr(tout, f), getattr(tout2, f)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f
    assert int(tn) == int(tn2) > 0.9 * K * N
    multi = np.asarray(fields["lm_valid"]) & (
        np.bincount(fields["kf_obs"][fields["kf_obs"] >= 0], minlength=96) >= 2)
    C = _centres(tout.kf_R, tout.kf_t)
    assert np.abs(C - _centres(R_gt, t_gt)).max() < 1e-2
    assert np.abs(tout.lm_pos.numpy() - pts)[multi].max() < 0.05
    for ref, n_ref in ((jout, jn), (single, sn)):
        np.testing.assert_allclose(C, _centres(ref.kf_R, ref.kf_t), atol=2e-3)
        d = np.linalg.norm(tout.lm_pos.numpy() - np.asarray(ref.lm_pos), axis=-1)
        assert np.median(d) < 1e-3
        assert abs(int(tn) - int(n_ref)) <= 0.02 * int(n_ref)


# -- landmark-sharded VI BA: test_vi_gba_sharded_parity_8_devices's map --

def _vi_inputs(seed=0):
    n_kf = 6
    st, inertial, *_ = test_vi_global_ba._build_map(n_kf=n_kf, seed=seed)
    rng = np.random.default_rng(3)
    R, tt = np.array(st.kf_R), np.array(st.kf_t)
    for w in range(1, n_kf):
        R[w] = R[w] @ np.asarray(jlie.so3_exp(jnp.asarray(
            rng.normal(0, 0.02, 3).astype(np.float32))))
        tt[w] = tt[w] + rng.normal(0, 0.05, 3)
    fields = leaves(st._replace(kf_R=jnp.asarray(R), kf_t=jnp.asarray(tt)))
    fixed = np.zeros(R.shape[0], bool)
    fixed[0] = True
    return st, inertial, fields, fixed, n_kf


def _vi_close(a, b, n_kf, lm_valid):
    """test_vi_gba_sharded_parity_8_devices's bars between two results."""
    (sa, na), (sb, nb) = a, b
    Rb, tb, lb = (np.asarray(getattr(sb, f)) for f in ("kf_R", "kf_t", "lm_pos"))
    np.testing.assert_allclose(sa.kf_t.numpy()[:n_kf], tb[:n_kf], atol=2e-3)
    for w in range(n_kf):
        assert np.trace(Rb[w] @ sa.kf_R.numpy()[w].T) > 3 - 1e-4
    assert abs(int(na) - int(nb)) <= 0.02 * max(int(nb), 1)
    d = np.linalg.norm(sa.lm_pos.numpy() - lb, axis=-1)[lm_valid]
    assert np.median(d) < 1e-3, float(np.median(d))


def test_run_global_vi_ba_sharded(jmesh):
    st, inertial, fields, fixed, n_kf = _vi_inputs()
    tin = convert.fields_from_numpy(tvi.VIInertialFactors, leaves(inertial), "cpu",
                                    index=("idx_i", "idx_j"))
    tcal = convert.imu_calib_from_numpy(leaves(test_vi_global_ba.CALIB), "cpu")
    vcam = TCamera.pinhole(test_vi_global_ba.CAM.fx, test_vi_global_ba.CAM.fy,
                           test_vi_global_ba.CAM.cx, test_vi_global_ba.CAM.cy)
    bf = float(test_vi_global_ba.BF)

    def port(sharded):
        s = convert.map_state_from_numpy({k: a.copy() for k, a in fields.items()}, "cpu")
        if sharded:
            return tvg.run_global_vi_ba_sharded(s, tin, torch.ones(4), vcam, bf, tcal,
                                                torch.from_numpy(fixed), tmesh(),
                                                n_levels=4, scale=1.2)
        return tvg.run_global_vi_ba(s, tin, torch.ones(4), vcam, bf, tcal,
                                    torch.from_numpy(fixed), n_levels=4, scale=1.2)

    jst = type(st)(**{k: jnp.asarray(a.copy()) for k, a in fields.items()})
    jout = jvg.run_global_vi_ba_sharded(jst, inertial, jnp.ones(4), test_vi_global_ba.CAM,
                                        test_vi_global_ba.BF, test_vi_global_ba.CALIB,
                                        jnp.asarray(fixed), jmesh("lm"), n_levels=4,
                                        scale=1.2)
    sharded, single = port(True), port(False)
    lmv = fields["lm_valid"]
    _vi_close(sharded, jout, n_kf, lmv)
    _vi_close(sharded, single, n_kf, lmv)
    np.testing.assert_array_equal(sharded[0].kf_obs.numpy(), np.asarray(jout[0].kf_obs))
    np.testing.assert_array_equal(sharded[0].kf_t.numpy()[fixed], fields["kf_t"][fixed])
