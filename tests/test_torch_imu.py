"""Parity of the port's IMU preintegration with the JAX package: `integrate`
on windows of S = 16 and 256 samples with zero-padded tails (the port
batches the windows, the reference vmaps them), the bias-corrected deltas,
`merge` and `predict_state`.

Tolerances: dR, dV, dP and the bias Jacobians within rtol 1e-5 (atol 1e-6
for entries near zero); the covariances within rtol 1e-4 of their largest
entry: float32 sums over up to 256 steps taken in another order.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu.imu import preintegration as jpre
from orb_slam3_vio_fixes_tpu.utils import lie as jlie
from orb_slam3_vio_fixes_tpu_torch import convert
from orb_slam3_vio_fixes_tpu_torch.frontend import inertial_tracking as tit
from orb_slam3_vio_fixes_tpu_torch.imu import preintegration as tpre
from orb_slam3_vio_fixes_tpu_torch.runtime import tracing

torch.set_num_threads(2)


ARGS = (1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)
JCAL = jpre.ImuCalib.make(*ARGS)
TCAL = tpre.ImuCalib.make(*ARGS, device="cpu")
DELTAS = ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "bg0", "ba0")


def windows(rng, n_win, S, n_used):
    """Exciting IMU windows at 200 Hz; rows past n_used[w] are dt = 0 pads."""
    acc = rng.normal(0, 1.5, (n_win, S, 3)) + np.array([0.0, 0.0, 9.81])
    gyro = rng.normal(0, 0.4, (n_win, S, 3))
    dt = np.full((n_win, S, 1), 1.0 / 200.0)
    w = np.concatenate([acc, gyro, dt], -1).astype(np.float32)
    for i, n in enumerate(n_used):
        w[i, n:] = 0.0
    return w


def port(p: jpre.Preintegrated) -> tpre.Preintegrated:
    return convert.preintegrated_from_numpy(
        {f: np.array(getattr(p, f)) for f in jpre.Preintegrated._fields}, "cpu")


def check(got: tpre.Preintegrated, ref: jpre.Preintegrated):
    for f in DELTAS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    for f in ("cov", "cov_walk"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max(),
                                   err_msg=f)


def test_integrate():
    """A frame window (S = 16) and a keyframe window (S = 256), each batch
    with zero-padded tails (each case from the seed-0 stream)."""
    for S, n_used in ((16, (16, 10, 0)), (256, (256, 200, 5))):
        rng = np.random.default_rng(0)
        w = windows(rng, len(n_used), S, n_used)
        bg = rng.normal(0, 0.01, (len(n_used), 3)).astype(np.float32)
        ba = rng.normal(0, 0.05, (len(n_used), 3)).astype(np.float32)
        ref = jax.vmap(lambda a, g, b: jpre.integrate(a, g, b, JCAL))(
            jnp.asarray(w), jnp.asarray(bg), jnp.asarray(ba))
        got = tpre.integrate(torch.from_numpy(w), torch.from_numpy(bg),
                             torch.from_numpy(ba), TCAL)
        check(got, ref)
        if n_used[2] == 0:   # an all-pad window is the identity
            assert torch.equal(got.dR[2], torch.eye(3))


@pytest.mark.parametrize("capacity, n_used, dt_zero, batched", [
    # mixed real lengths with an empty window; with one at full capacity
    pytest.param(64, (0, 17, 3, 40), (), True, id="mixed_empty"),
    pytest.param(64, (64, 0, 10), (), True, id="mixed_full"),
    # real rows with dt = 0: one inside the longest window (a count of the
    # dt > 0 rows would cut its tail), one that ends a window
    pytest.param(64, (30, 12, 0), ((0, 10), (1, 11)), True, id="real_dt_zero"),
    # the call sites at small capacities: a frame's window (unbatched), the
    # window BA's W - 1 = 7 pairs, the IMU init's merged pairs at twice the
    # keyframe capacity and the full-map chain over max_keyframes - 1 slots
    pytest.param(16, (11,), (), False, id="frame"),
    pytest.param(128, (27, 31, 19, 58, 0, 26, 30), (), True, id="window_ba"),
    pytest.param(256, (61, 55, 88, 47) + (0,) * 27, (), True, id="imu_init"),
    pytest.param(128, (27, 31, 19, 24, 33, 26, 30, 29, 25) + (0,) * 22, (), True,
                 id="full_map"),
])
def test_integrate_trimmed_is_exact(capacity, n_used, dt_zero, batched):
    """integrate on the blocks padded to their capacity and on the same
    blocks cut by inertial_tracking.pack_imu: equal in every field. The
    block is as long as the longest window up to its last row with
    dt != 0, and the helper counts its rows and the ones it left out."""
    rng = np.random.default_rng(capacity + len(n_used))
    w = windows(rng, len(n_used), capacity, n_used)
    for i, r in dt_zero:
        w[i, r, 6] = 0.0
    real = [np.flatnonzero(x[:, 6] != 0) for x in w]
    S = max([1] + [int(r[-1]) + 1 for r in real if r.size])
    assert S < capacity or capacity in n_used
    tr = tracing.Tracer()
    with tracing.traced(tr):
        cut = tit.pack_imu([x[:n] for x, n in zip(w, n_used)], capacity)
    assert cut.shape == (len(n_used), S, 7) and np.array_equal(cut, w[:, :S])
    assert tr.counters == {"imu.rows_integrated": S, "imu.rows_skipped": capacity - S}
    bg = torch.from_numpy(rng.normal(0, 0.01, (len(n_used), 3)).astype(np.float32))
    ba = torch.from_numpy(rng.normal(0, 0.05, (len(n_used), 3)).astype(np.float32))
    if not batched:
        w, cut, bg, ba = w[0], cut[0], bg[0], ba[0]
    full = tpre.integrate(torch.from_numpy(w), bg, ba, TCAL)
    got = tpre.integrate(torch.from_numpy(cut), bg, ba, TCAL)
    for f in tpre.Preintegrated._fields:
        assert torch.equal(getattr(got, f), getattr(full, f)), f


def test_bias_corrected_deltas_merge_predict(rng):
    w = windows(rng, 2, 64, (64, 40))
    bg0 = rng.normal(0, 0.01, (2, 3)).astype(np.float32)
    ba0 = rng.normal(0, 0.05, (2, 3)).astype(np.float32)
    jp = [jpre.integrate(jnp.asarray(w[i]), jnp.asarray(bg0[i]), jnp.asarray(ba0[i]),
                         JCAL) for i in range(2)]
    tp = [port(p) for p in jp]
    bg = jnp.asarray(bg0[0] + 0.003)
    ba = jnp.asarray(ba0[0] - 0.02)
    tbg, tba = torch.from_numpy(np.array(bg)), torch.from_numpy(np.array(ba))
    for jf, tf, args in ((jpre.delta_rotation, tpre.delta_rotation, (1,)),
                         (jpre.delta_velocity, tpre.delta_velocity, (1, 2)),
                         (jpre.delta_position, tpre.delta_position, (1, 2))):
        jargs = [bg, ba][:len(args)]
        targs = [tbg, tba][:len(args)]
        np.testing.assert_allclose(tf(tp[0], *targs).numpy(),
                                   np.asarray(jf(jp[0], *jargs)), rtol=1e-5, atol=1e-6)
    check(tpre.merge(tp[0], tp[1]), jpre.merge(jp[0], jp[1]))
    R = np.array(jlie.so3_exp(jnp.array([0.1, -0.2, 0.3], jnp.float32)))
    p, v = np.array([1.0, 2.0, 0.5], np.float32), np.array([0.3, -0.1, 0.2], np.float32)
    ref = jpre.predict_state(jnp.asarray(R), jnp.asarray(p), jnp.asarray(v), bg, ba, jp[0])
    got = tpre.predict_state(*(torch.from_numpy(x) for x in (R, p, v)), tbg, tba, tp[0])
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
