"""The port's loop closing (frontend/loop_closing.py) against the JAX
package's on tests/test_loop_closing.py's map-level scenario: an out-and-back
trajectory whose revisit keyframe sees the loop site through duplicated,
drift-displaced landmarks.

The RANSAC draws are the JAX package's: the port's sampler is replaced by
one that draws each index set with jax.random.categorical under the same key
chain as the JAX orchestrator, on the port's own validity mask; equal masks
give equal samples.

Tolerances: candidate lists, match counts and RANSAC inlier counts exact
(integer decisions on the same inputs); the refined Sim3 within 1e-4
(rotation, scale) and 1e-3 m (translation), Gauss-Newton in float32 on
both sides; corrected keyframe poses within 1e-3 and landmarks within
2e-3 m after the pose graph (a float32 Cholesky of a 112x112 system);
apply_correction on the same inputs within 1e-5.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu.frontend import loop_closing as jlc
from orb_slam3_vio_fixes_tpu_torch import convert
from orb_slam3_vio_fixes_tpu_torch.frontend import loop_closing as tlc
from orb_slam3_vio_fixes_tpu_torch.ops import pnp as tpnp
from orb_slam3_vio_fixes_tpu_torch.ops import sim3 as tsim3
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera as TCamera

from test_loop_closing import CAM, M, N_KF, _make_scenario

torch.set_num_threads(2)

TCAM = TCamera.pinhole(CAM.fx, CAM.fy, CAM.cx, CAM.cy)


class JaxDraws:
    """Replaces the port's RANSAC sampler: draws (n_hyp, k) indices with
    jax.random.categorical over the port's validity mask, under the key
    chain of a JAX orchestrator (split once per call when `per_call`, and
    once more inside the RANSAC when `inner_split`, as sim3_ransac does)."""

    def __init__(self, key, per_call: bool, inner_split: bool):
        self.key = key
        self.per_call = per_call
        self.inner_split = inner_split

    def __call__(self, gen, valid, n_hyp, k):
        sub = self.key
        if self.per_call:
            self.key, sub = jax.random.split(self.key)
        if self.inner_split:
            sub = jax.random.split(sub)[0]
        logits = jnp.where(jnp.asarray(valid.cpu().numpy()), 0.0, -1e9)
        idx = jax.random.categorical(sub, logits[None, :], shape=(n_hyp, k))
        return torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=valid.device)


def jax_sim3_draws(monkeypatch, key, per_call):
    monkeypatch.setattr(tsim3, "sample", JaxDraws(key, per_call, inner_split=True))


def jax_pnp_draws(monkeypatch, key, per_call):
    monkeypatch.setattr(tpnp, "sample", JaxDraws(key, per_call, inner_split=False))


def port_state(jstate, device="cpu"):
    return convert.map_state_from_numpy(
        {f: np.array(getattr(jstate, f), copy=True) for f in jstate._fields}, device)


def port_vocab(jvocab, device="cpu"):
    return convert.vocabulary_from_numpy(np.asarray(jvocab.nodes),
                                         np.asarray(jvocab.weights),
                                         jvocab.branching, jvocab.depth, device)


def jax_copy(jstate):
    return jax.tree.map(lambda a: jnp.asarray(np.array(a, copy=True)), jstate)


SCENARIOS = {
    "drift": {},
    "small_drift": dict(drift_t=np.array([0.08, 0.03, 0.0], np.float32),
                        drift_rvec=np.array([0.0, 0.01, 0.0], np.float32)),
    "drift_beyond_guided_radius": dict(drift_t=np.array([4.0, 1.5, 0.0], np.float32),
                                       drift_rvec=np.array([0.0, 0.35, 0.0], np.float32)),
}


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def scenario(request):
    return _make_scenario(**SCENARIOS[request.param])


def _closers(sc, cfg):
    jc = jlc.LoopCloser(sc["vocab"], CAM, 16, np.ones(4, np.float32), cfg=cfg)
    tc = tlc.LoopCloser(port_vocab(sc["vocab"]), TCAM, 16, np.ones(4, np.float32),
                        cfg=tlc.LoopConfig(**cfg._asdict()), device="cpu")
    return jc, tc


def test_same_candidates(scenario):
    cfg = jlc.LoopConfig(min_gap_kfs=8, min_score=0.02, run_gba=False, n_consistency=1)
    jc, tc = _closers(scenario, cfg)
    js, ts = scenario["state"], port_state(scenario["state"])
    kf = scenario["kf_last"]
    for k in range(N_KF - 1):
        jc.add_keyframe(js, k)
        tc.add_keyframe(ts, k)
    jh = jc.add_keyframe(js, kf)
    th = tc.add_keyframe(ts, kf)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-6)
    np.testing.assert_allclose(tc.db.hist.numpy(), np.asarray(jc.db.hist), atol=1e-6)
    cands = tc.detect(ts, kf, th)
    assert cands == jc.detect(js, kf, jh)
    assert 0 in cands


def test_verify_candidate_gates_agree(scenario, monkeypatch):
    js, ts = scenario["state"], port_state(scenario["state"])
    kf = scenario["kf_last"]
    key = jax.random.PRNGKey(0)
    jn_m, jn_r, jn_p, jsim = jlc.verify_candidate(
        key, js, jnp.int32(kf), jnp.int32(0), CAM, jnp.ones(4), 256, True, n_levels=4)
    jax_sim3_draws(monkeypatch, key, per_call=False)
    tn_m, tn_r, tn_p, tsim = tlc.verify_candidate(
        None, ts, kf, 0, TCAM, torch.ones(4), 256, True, n_levels=4)
    assert int(tn_m) == int(jn_m) >= 40
    assert int(tn_r) == int(jn_r) >= 40
    assert int(tn_p) == int(jn_p) >= 40
    assert int(tsim.n_inliers) == int(jsim.n_inliers)
    np.testing.assert_allclose(tsim.R.numpy(), np.asarray(jsim.R), atol=1e-4)
    np.testing.assert_allclose(tsim.t.numpy(), np.asarray(jsim.t), atol=1e-3)
    assert abs(float(tsim.s) - float(jsim.s)) < 1e-4


def test_correction_agrees(scenario, monkeypatch):
    cfg = jlc.LoopConfig(min_gap_kfs=8, min_score=0.02, run_gba=False, n_consistency=1)
    jc, tc = _closers(scenario, cfg)
    js, ts = jax_copy(scenario["state"]), port_state(scenario["state"])
    kf = scenario["kf_last"]
    for k in range(N_KF - 1):
        jc.add_keyframe(js, k)
        tc.add_keyframe(ts, k)
    js2, jres = jc.on_keyframe(js, kf, N_KF)
    jax_sim3_draws(monkeypatch, jax.random.PRNGKey(7), per_call=True)
    ts2, tres = tc.on_keyframe(ts, kf, N_KF)
    assert jres is not None and jres.corrected and tres == jres
    np.testing.assert_allclose(ts2.kf_R.numpy(), np.asarray(js2.kf_R), atol=1e-3)
    np.testing.assert_allclose(ts2.kf_t.numpy(), np.asarray(js2.kf_t), atol=1e-3)
    np.testing.assert_allclose(ts2.lm_pos[:2 * M].numpy(), np.asarray(js2.lm_pos[:2 * M]),
                               atol=2e-3)
    C_before = -scenario["R_est"][kf].T @ scenario["t_est"][kf]
    C_after = -ts2.kf_R[kf].numpy().T @ ts2.kf_t[kf].numpy()
    centre = scenario["centers"][kf]
    assert np.linalg.norm(C_after - centre) < 0.25 * np.linalg.norm(C_before - centre)


def test_apply_correction_agrees(scenario):
    rng = np.random.default_rng(1)
    K = scenario["state"].kf_R.shape[0]
    w = rng.normal(0, 0.05, (K, 3)).astype(np.float32)
    dR = np.stack([np.asarray(jax.scipy.linalg.expm(jnp.asarray(
        [[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]], jnp.float32))) for a in w])
    R = np.einsum("kij,kjl->kil", dR, np.asarray(scenario["state"].kf_R)).astype(np.float32)
    t = (np.asarray(scenario["state"].kf_t) + rng.normal(0, 0.1, (K, 3))).astype(np.float32)
    s = rng.uniform(0.9, 1.1, K).astype(np.float32)
    ts = port_state(scenario["state"])
    js2 = jlc.apply_correction(jax_copy(scenario["state"]), jnp.asarray(R),
                               jnp.asarray(t), jnp.asarray(s), n_levels=4)
    ts2 = tlc.apply_correction(ts, torch.as_tensor(R), torch.as_tensor(t),
                               torch.as_tensor(s), n_levels=4)
    for f in ("kf_R", "kf_t", "kf_vel", "lm_pos", "lm_normal", "lm_maxdist", "lm_mindist"):
        np.testing.assert_allclose(getattr(ts2, f).numpy(), np.asarray(getattr(js2, f)),
                                   atol=1e-5, rtol=1e-5, err_msg=f)


def test_temporal_consistency_gates_single_hit(scenario, monkeypatch):
    """Port twin of test_loop_closing's gate: one verified hit of a 3-keyframe
    chain leaves the map as it was."""
    cfg = jlc.LoopConfig(min_gap_kfs=8, min_score=0.02, run_gba=False, n_consistency=3)
    _, tc = _closers(scenario, cfg)
    ts = port_state(scenario["state"])
    kf_t = ts.kf_t.clone()
    for k in range(N_KF - 1):
        tc.add_keyframe(ts, k)
    jax_sim3_draws(monkeypatch, jax.random.PRNGKey(7), per_call=True)
    ts2, res = tc.on_keyframe(ts, scenario["kf_last"], N_KF)
    assert res is not None and not res.corrected
    assert tc.n_corrections == 0
    assert torch.equal(ts2.kf_t, kf_t)


def test_database_bookkeeping_agrees():
    """grow, rebuild_after_merge and reset move the database rows and the
    consistency chain as the JAX closer does."""
    sc = _make_scenario()
    cfg = jlc.LoopConfig(min_gap_kfs=8, min_score=0.02, run_gba=False, n_consistency=3)
    jc, tc = _closers(sc, cfg)
    js, ts = sc["state"], port_state(sc["state"])
    for k in range(N_KF):
        jc.add_keyframe(js, k)
        tc.add_keyframe(ts, k)
    jc.grow(24)
    tc.grow(24)
    np.testing.assert_allclose(tc.db.hist.numpy(), np.asarray(jc.db.hist), atol=1e-6)
    old = np.random.default_rng(0).uniform(0, 0.1, (5, sc["vocab"].n_words)).astype(np.float32)
    for c in (jc, tc):
        c._pending_group, c._pending_count = {1, 2}, 2
        c.rebuild_after_merge(old, 5, N_KF)
    np.testing.assert_allclose(tc.db.hist.numpy(), np.asarray(jc.db.hist), atol=1e-6)
    assert (tc._pending_group, tc._pending_count) == (jc._pending_group,
                                                      jc._pending_count) == (None, 0)
    held = tc.db
    jc.reset()
    tc.reset()
    assert tc.db.hist.shape == tuple(jc.db.hist.shape) and not bool(tc.db.hist.any())
    assert bool(held.hist.any())    # a stashed map keeps the old rows


def test_loop_closer_state_converts(monkeypatch):
    """A port closer given the JAX closer's database and pending chain
    (convert.load_loop_closer_state) completes the chain the same way."""
    sc = _make_scenario()
    cfg = jlc.LoopConfig(min_gap_kfs=8, min_score=0.02, run_gba=False, n_consistency=2)
    jc, tc = _closers(sc, cfg)
    js, ts = jax_copy(sc["state"]), port_state(sc["state"])
    kf = sc["kf_last"]
    for k in range(N_KF - 1):
        jc.add_keyframe(js, k)
    jc._pending_group, jc._pending_count = {0, 1}, 1
    convert.load_loop_closer_state(tc, np.asarray(jc.db.hist), jc._pending_group,
                                   jc._pending_count)
    js2, jres = jc.on_keyframe(js, kf, N_KF)
    jax_sim3_draws(monkeypatch, jax.random.PRNGKey(7), per_call=True)
    ts2, tres = tc.on_keyframe(ts, kf, N_KF)
    assert tres == jres and tres.corrected and tc.n_corrections == jc.n_corrections == 1
    np.testing.assert_allclose(ts2.kf_t.numpy(), np.asarray(js2.kf_t), atol=1e-3)


@pytest.mark.parametrize("n_valid", [1, 40])
def test_recent_slots_excluded(n_valid):
    """detect() leaves out the recent slots it is given, as the reference."""
    sc = _make_scenario()
    cfg = jlc.LoopConfig(min_gap_kfs=8, min_score=0.0, run_gba=False)
    jc, tc = _closers(sc, cfg)
    js, ts = sc["state"], port_state(sc["state"])
    for k in range(N_KF):
        jc.add_keyframe(js, k)
        h = tc.add_keyframe(ts, k)
    recent = [0] if n_valid == 1 else list(range(N_KF - 1, N_KF - 9, -1))
    jh = jc.add_keyframe(js, N_KF - 1)
    assert tc.detect(ts, N_KF - 1, h, recent_slots=recent) == \
        jc.detect(js, N_KF - 1, jh, recent_slots=recent)
