"""Parity of the port's full-map visual-inertial BA with the JAX package on
tests/test_vi_global_ba.py's perturbed map: all keyframes free but KF0, the
`pose_fixed` mask of a window-restricted run, and the factor / landmark
budgets the tracker passes (compaction path), with identity and EuRoC-like
extrinsics.

Tolerances: after 2 x 6 LM iterations of 40 float32 CG steps keyframe
poses within 1e-4 (R) and 1e-3 m (t), velocities within 1e-3 m/s,
landmarks within 1e-3 m, the unbound observations and the inlier count
identical. Landmark row 0 is left out: the reference's compacted write-back
reverts it through its pad slots, the port's does not.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu.optim import vi_global_ba as jvg
from orb_slam3_vio_fixes_tpu.utils import lie as jlie
from orb_slam3_vio_fixes_tpu_torch import convert
from orb_slam3_vio_fixes_tpu_torch.optim import vi_ba as tvi
from orb_slam3_vio_fixes_tpu_torch.optim import vi_global_ba as tvg
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera as TCamera

from test_vi_global_ba import BF, CALIB, CAM, _build_map, _nonidentity_calib

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """Free the JAX executables this module compiled once it ends."""
    yield
    jax.clear_caches()
    gc.collect()


TCAM = TCamera.pinhole(400.0, 400.0, 320.0, 240.0)


def leaves(nt) -> dict:
    return {k: np.array(v) for k, v in nt._asdict().items()}


CASES = {
    "all_free": dict(seed=0, fixed=lambda K: np.arange(K) == 0, budgets={}),
    "window_mask": dict(seed=1, fixed=lambda K: ~np.isin(np.arange(K), [3, 4, 5]),
                        budgets={}),
    "budgets_extrinsics": dict(seed=2, fixed=lambda K: np.arange(K) == 0,
                               budgets=dict(f_budget=1024, lm_budget=128),
                               calib=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_run_global_vi_ba(name):
    c = CASES[name]
    calib = _nonidentity_calib() if c.get("calib") else CALIB
    n_kf = 6
    st, inertial, *_ = _build_map(n_kf=n_kf, seed=c["seed"], calib=calib)
    rng = np.random.default_rng(3)
    R, tt, v = np.array(st.kf_R), np.array(st.kf_t), np.array(st.kf_vel)
    for w in range(1, n_kf):
        R[w] = R[w] @ np.asarray(jlie.so3_exp(jnp.asarray(
            rng.normal(0, 0.02, 3).astype(np.float32))))
        tt[w] += rng.normal(0, 0.05, 3)
        v[w] += rng.normal(0, 0.1, 3)
    fields = leaves(st._replace(kf_R=jnp.asarray(R), kf_t=jnp.asarray(tt),
                                kf_vel=jnp.asarray(v)))
    K = R.shape[0]
    fixed = c["fixed"](K)
    tstate = convert.map_state_from_numpy(fields, "cpu")
    tin = convert.fields_from_numpy(tvi.VIInertialFactors, leaves(inertial), "cpu",
                                   index=("idx_i", "idx_j"))
    tcal = convert.imu_calib_from_numpy(leaves(calib), "cpu")
    tout, tn = tvg.run_global_vi_ba(tstate, tin, torch.ones(4), TCAM, float(BF), tcal,
                                    torch.from_numpy(fixed), n_levels=4, scale=1.2,
                                    **c["budgets"])
    jst = type(st)(**{k: jnp.asarray(a) for k, a in fields.items()})
    jout, jn = jvg.run_global_vi_ba(jst, inertial, jnp.ones(4), CAM, BF, calib,
                                    jnp.asarray(fixed), n_levels=4, scale=1.2,
                                    **c["budgets"])
    np.testing.assert_allclose(tout.kf_R.numpy(), np.asarray(jout.kf_R), atol=1e-4)
    np.testing.assert_allclose(tout.kf_t.numpy(), np.asarray(jout.kf_t), atol=1e-3)
    np.testing.assert_allclose(tout.kf_vel.numpy(), np.asarray(jout.kf_vel), atol=1e-3)
    np.testing.assert_allclose(tout.lm_pos.numpy()[1:], np.asarray(jout.lm_pos)[1:],
                               atol=1e-3)
    np.testing.assert_array_equal(tout.kf_obs.numpy(), np.asarray(jout.kf_obs))
    assert int(tn) == int(jn) > 400
    np.testing.assert_array_equal(tout.kf_t.numpy()[fixed], fields["kf_t"][fixed])
