"""Parity of the port's inertial initialisation with the JAX package on the
problems tests/test_inertial_init.py builds: `inertial_optimization` in
fixed-scale and free-scale modes (and the errors-in-variables whitening the
monocular init uses), the factors built from the port's own preintegration,
`gravity_bootstrap` and `apply_scaled_rotation`.

Tolerances: factors' info within rtol 1e-3 of its largest entry (an eigen
pseudo-inverse of a float32 covariance); after 40-60 float32 LM iterations
velocities within 2e-3 m/s, biases within 2e-4, R_wg within 1e-4, scale
within rtol 1e-4, the first chi2 within rtol 1e-3 and the converged last one
within 1e-3 absolute (a sum of near-zero squares).
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu.optim import inertial_init as jii
from orb_slam3_vio_fixes_tpu.utils import lie as jlie
from orb_slam3_vio_fixes_tpu_torch import convert
from orb_slam3_vio_fixes_tpu_torch.imu import preintegration as tpre
from orb_slam3_vio_fixes_tpu_torch.optim import inertial_init as tii

from test_inertial_init import _build_factors, _simulate

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """Free the JAX executables this module compiled once it ends."""
    yield
    jax.clear_caches()
    gc.collect()


def t(x):
    return torch.from_numpy(np.array(x))


def port_factors(f: jii.InertialInitFactors) -> tii.InertialInitFactors:
    return convert.fields_from_numpy(tii.InertialInitFactors,
                                    {k: np.asarray(v) for k, v in f._asdict().items()},
                                    "cpu", index=("idx_i", "idx_j"))


CASES = {
    "fixed_scale": dict(
        sim=dict(bg=np.array([0.02, -0.015, 0.01], np.float32),
                 world_rot=np.asarray(jlie.so3_exp(jnp.asarray(
                     [np.deg2rad(15.0), 0.0, 0.0], jnp.float32)))),
        scale=1.0, cfg=dict(n_iters=40, prior_gyro=1.0, prior_acc=1e6, fix_scale=True)),
    "free_scale": dict(sim=dict(seed=1), scale=2.5,
                       cfg=dict(n_iters=60, prior_gyro=1.0, prior_acc=1e6,
                                fix_scale=False)),
    "acc_bias": dict(sim=dict(ba=np.array([0.05, -0.03, 0.08], np.float32), seed=2),
                     scale=1.0, cfg=dict(n_iters=60, prior_gyro=1.0, prior_acc=1e-2,
                                         fix_scale=True)),
    "free_scale_eiv": dict(sim=dict(seed=1), scale=2.5,
                           cfg=dict(n_iters=60, fix_scale=False, sigma_vis_rot=5e-3,
                                    sigma_vis_pos=1e-2), seed_scale=1.5,
                           bias=(np.array([0.001, 0.0, -0.002], np.float32),
                                 np.array([0.01, 0.02, 0.0], np.float32))),
}


@pytest.mark.parametrize("name", list(CASES))
def test_inertial_optimization(name):
    c = CASES[name]
    kf_R, kf_p, kf_v, windows = _simulate(**c["sim"])
    kf_p = kf_p / c["scale"]
    jf = _build_factors(kf_R, windows)
    kw = {}
    tkw = {}
    if "bias" in c:
        kw = dict(bg_init=jnp.asarray(c["bias"][0]), ba_init=jnp.asarray(c["bias"][1]),
                  scale_init=jnp.float32(c["seed_scale"]))
        tkw = dict(bg_init=t(c["bias"][0]), ba_init=t(c["bias"][1]),
                   scale_init=c["seed_scale"])
    ref = jii.inertial_optimization(
        jnp.asarray(kf_R), jnp.asarray(kf_p), jnp.zeros_like(jnp.asarray(kf_v)), jf,
        jii.InertialInitConfig(**c["cfg"]), **kw)
    got = tii.inertial_optimization(
        t(kf_R), t(kf_p), torch.zeros(kf_v.shape), port_factors(jf),
        tii.InertialInitConfig(**c["cfg"]), **tkw)
    v, bg, ba, Rwg, s, chi2 = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(got[0].numpy(), v, atol=2e-3)
    np.testing.assert_allclose(got[1].numpy(), bg, atol=2e-4)
    np.testing.assert_allclose(got[2].numpy(), ba, atol=2e-4)
    np.testing.assert_allclose(got[3].numpy(), Rwg, atol=1e-4)
    np.testing.assert_allclose(float(got[4]), float(s), rtol=1e-4)
    np.testing.assert_allclose(got[5].numpy()[0], chi2[0], rtol=1e-3)
    np.testing.assert_allclose(got[5].numpy()[-1], chi2[-1], rtol=1e-3, atol=1e-3)


def test_factors_bootstrap_and_scaled_rotation(rng):
    check_factors_from_port_preintegration()
    check_gravity_bootstrap_and_scaled_rotation(rng)


def check_factors_from_port_preintegration():
    kf_R, _, _, windows = _simulate(n_kf=5)
    jf = _build_factors(kf_R, windows)
    cal = tpre.ImuCalib.make(1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0, device="cpu")
    z = torch.zeros(3)
    pres = tpre.integrate(t(windows), z, z, cal)
    n = windows.shape[0]
    tf = tii.factors_from_preintegrations(np.arange(n), np.arange(1, n + 1), pres,
                                          np.ones(n, bool))
    for f in ("dT", "dR", "dV", "dP", "JRg", "JVa", "JPa"):
        np.testing.assert_allclose(getattr(tf, f).numpy(), np.asarray(getattr(jf, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    ref_info = np.asarray(jf.info)
    np.testing.assert_allclose(tf.info.numpy(), ref_info,
                               atol=1e-3 * np.abs(ref_info).max())


def check_gravity_bootstrap_and_scaled_rotation(rng):
    kf_R, kf_p, _, windows = _simulate(seed=3, world_rot=np.asarray(jlie.so3_exp(
        jnp.asarray([0.2, -0.1, 0.0], jnp.float32))))
    jf = _build_factors(kf_R, windows)
    n = windows.shape[0]
    valid = np.ones(n, bool)
    valid[-2:] = False
    ref = jii.gravity_bootstrap(jnp.asarray(kf_R[:-1]), jf.dV, jnp.asarray(valid))
    got = tii.gravity_bootstrap(t(kf_R[:-1]), t(jf.dV), t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)

    K, L = 4, 50
    R = np.stack([np.asarray(jlie.so3_exp(jnp.asarray(
        rng.normal(0, 0.2, 3).astype(np.float32)))) for _ in range(K)])
    args = (R, rng.normal(0, 1, (K, 3)).astype(np.float32),
            rng.normal(0, 1, (K, 3)).astype(np.float32),
            rng.normal(0, 2, (L, 3)).astype(np.float32),
            np.asarray(jlie.so3_exp(jnp.asarray([0.3, -0.2, 0.1], jnp.float32))))
    ref = jii.apply_scaled_rotation(*(jnp.asarray(a) for a in args), jnp.float32(1.7))
    got = tii.apply_scaled_rotation(*(t(a) for a in args), torch.tensor(1.7))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
