"""Parity of the port's IMU preintegration with the JAX package: `integrate`
on windows of S = 16 and 256 samples with zero-padded tails (the port
batches the windows, the reference vmaps them), the bias-corrected deltas,
`merge` and `predict_state`.

Tolerances: dR, dV, dP and the bias Jacobians within rtol 1e-5 (atol 1e-6
for entries near zero); the covariances within rtol 1e-4 of their largest
entry: float32 sums over up to 256 steps taken in another order.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu.imu import preintegration as jpre
from orb_slam3_vio_fixes_tpu.utils import lie as jlie
from orb_slam3_vio_fixes_tpu_torch import convert
from orb_slam3_vio_fixes_tpu_torch.imu import preintegration as tpre

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """Free the JAX executables this module compiled once it ends (each holds
    memory mappings; an xdist worker has a per-process limit)."""
    yield
    jax.clear_caches()
    gc.collect()


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
