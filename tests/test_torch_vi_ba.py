"""Parity of the port's visual-inertial BA with the JAX package on the
problems tests/test_vi_ba.py builds: the motion-only (landmarks fixed),
window (landmarks free, two anchors) and prior-only problems through
`solve_vi_ba`, and `marginalize`. Also the port's closed-form factor
Jacobians against forward-mode autodiff of its residual functions, on
random states (within 1e-4 of the largest entry: float32 rounding).

Tolerances: after 6-16 float32 LM iterations states within 1e-4 (R, p in
m, v in m/s, biases), landmarks within 1e-3 m, inlier masks identical; the
final information within rtol 1e-3 of its largest entry; `marginalize`
within 1e-3 of its largest entry (eigen pseudo-inverse in float32).
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu.optim import vi_ba as jvi
from orb_slam3_vio_fixes_tpu_torch import convert
from orb_slam3_vio_fixes_tpu_torch.optim import vi_ba as tvi
from orb_slam3_vio_fixes_tpu_torch.utils import lie
from orb_slam3_vio_fixes_tpu_torch.utils.autodiff import jac_rows
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera as TCamera

from test_vi_ba import (_inertial_factors, _landmarks_and_factors, _problem,
                        _simulate_states)

torch.set_num_threads(2)


TCAM = TCamera.pinhole(400.0, 400.0, 320.0, 240.0)


def leaves(nt) -> dict:
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def port_problem(p: jvi.VIProblem) -> tvi.VIProblem:
    return convert.vi_problem_from_numpy(
        leaves(p.states), np.asarray(p.lm), np.asarray(p.lm_valid),
        np.asarray(p.lm_fixed), leaves(p.reproj), leaves(p.inertial), leaves(p.prior),
        TCAM, p.bf, np.asarray(p.R_cb), np.asarray(p.t_cb), "cpu")


def motion_only():
    kf_R, kf_p, kf_v, windows = _simulate_states(n_kf=2)
    lm, reproj = _landmarks_and_factors(kf_R, kf_p)
    return _problem(kf_R, kf_p, kf_v, lm, reproj, _inertial_factors(windows),
                    np.array([True, False]), perturb_seed=1, pose_noise=0.01,
                    lm_fixed=True), jvi.VIBAConfig(n_rounds=2, n_iters=6)


def window():
    kf_R, kf_p, kf_v, windows = _simulate_states(n_kf=5)
    lm, reproj = _landmarks_and_factors(kf_R, kf_p, px_noise=0.0)
    lm_bad = lm + np.random.default_rng(7).normal(0, 0.02, lm.shape).astype(np.float32)
    return _problem(kf_R, kf_p, kf_v, lm_bad, reproj, _inertial_factors(windows),
                    np.array([True, True, False, False, False]), perturb_seed=2,
                    pose_noise=0.008), jvi.VIBAConfig(n_rounds=2, n_iters=8)


def prior_only():
    kf_R, kf_p, kf_v, windows = _simulate_states(n_kf=2)
    lm, reproj = _landmarks_and_factors(kf_R, kf_p, n_lm=5)
    reproj = reproj._replace(valid=jnp.zeros_like(reproj.valid))
    prob = _problem(kf_R, kf_p, kf_v, lm, reproj, _inertial_factors(windows),
                    np.array([True, False]), perturb_seed=3, pose_noise=0.02,
                    lm_fixed=True)
    prior = jvi.VIPrior(state_idx=jnp.int32(1), R_wb=jnp.asarray(kf_R[1]),
                        p_wb=jnp.asarray(kf_p[1]), v=jnp.asarray(kf_v[1]),
                        bg=jnp.zeros(3), ba=jnp.zeros(3), H=jnp.eye(15) * 1e8,
                        valid=jnp.asarray(True))
    return prob._replace(prior=prior), jvi.VIBAConfig(n_rounds=1, n_iters=8)


@pytest.mark.parametrize("build", [motion_only, window, prior_only],
                         ids=["motion_only", "window", "prior"])
def test_solve_vi_ba(build):
    prob, cfg = build()
    jout, jin, jH = jvi.solve_vi_ba(prob, cfg)
    tout, tin, tH = tvi.solve_vi_ba(port_problem(prob), tvi.VIBAConfig(**cfg._asdict()))
    for f in ("R_wb", "p_wb", "v", "bg", "ba"):
        np.testing.assert_allclose(getattr(tout.states, f).numpy(),
                                   np.asarray(getattr(jout.states, f)), atol=1e-4,
                                   err_msg=f)
    np.testing.assert_allclose(tout.lm.numpy(), np.asarray(jout.lm), atol=1e-3)
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    jH = np.asarray(jH)
    np.testing.assert_allclose(tH.numpy(), jH, atol=1e-3 * np.abs(jH).max())


def test_marginalize(rng):
    A = rng.normal(0, 1, (30, 30))
    H = (A @ A.T + 30 * np.eye(30)).astype(np.float32)
    ref = np.asarray(jvi.marginalize(jnp.asarray(H), slice(15, 30), slice(0, 15)))
    got = tvi.marginalize(torch.from_numpy(H), slice(15, 30), slice(0, 15)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3 * np.abs(ref).max())


def _random_factor_args(rng, n):
    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(0, scale, shape)).astype(np.float32))

    def rot():
        return lie.so3_exp(t(n, 3, scale=0.3))

    def state():
        return [rot(), t(n, 3), t(n, 3), t(n, 3, scale=1e-2), t(n, 3, scale=1e-2)]

    return state, t, rot


def test_closed_form_jacobians(rng):
    for factor in ("reproj", "inertial", "bias_rw", "prior"):
        check_closed_form_jacobian(rng, factor)


def check_closed_form_jacobian(rng, factor):
    n = 32
    state, t, rot = _random_factor_args(rng, n)
    if factor == "reproj":
        R, p = rot(), t(n, 3, scale=0.1)
        lm = t(n, 3) + torch.tensor([0.0, 0.0, 5.0])
        uvr = torch.from_numpy(rng.uniform(0, 300, (n, 3)).astype(np.float32))
        R_cb, t_cb = lie.so3_exp(t(3, scale=0.2)), t(3, scale=0.1)

        def f(z, R, p, lm, uvr):
            return tvi.reproj_residual(z, R, p, lm, uvr, TCAM, 40.0, R_cb, t_cb)

        r0, J0 = jac_rows(f, torch.zeros(n, 9), R, p, lm, uvr)
        r1, Jp, Jl = tvi.reproj_jacobians(R, p, lm, uvr, TCAM, 40.0, R_cb, t_cb)
        J1 = torch.cat([Jp, torch.zeros(n, 3, 9), Jl], -1)
        J0 = torch.cat([J0[..., :6], torch.zeros(n, 3, 9), J0[..., 6:]], -1)
    elif factor == "inertial":
        args = (state() + state() + [torch.from_numpy(rng.uniform(0.05, 0.15, n).astype(
            np.float32)), rot(), t(n, 3), t(n, 3)] + [t(n, 3, 3, scale=0.1) for _ in range(5)]
            + [t(n, 3, scale=1e-2), t(n, 3, scale=1e-2)])
        r0, J0 = jac_rows(tvi.inertial_residual, torch.zeros(n, 30), *args)
        r1, J1 = tvi.inertial_jacobians(*args)
    elif factor == "bias_rw":
        args = [t(n, 3, scale=1e-2) for _ in range(4)]
        r0, J0 = jac_rows(tvi.bias_rw_residual, torch.zeros(n, 30), *args)
        r1 = tvi.bias_rw_residual(torch.zeros(n, 30), *args)
        J1 = tvi.bias_rw_jacobian(torch.device("cpu")).expand(n, 6, 30)
    else:
        args = state() + state()
        r0, J0 = jac_rows(tvi.prior_residual, torch.zeros(n, 15), *args)
        r1, J1 = tvi.prior_jacobians(*args)
    np.testing.assert_allclose(r1.numpy(), r0.numpy(), atol=1e-6 * float(r0.abs().max()))
    np.testing.assert_allclose(J1.numpy(), J0.numpy(), atol=1e-4 * float(J0.abs().max()))
