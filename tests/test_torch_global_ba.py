"""The port's matrix-free CG Schur solver (optim/ba_core.py, solver="cg")
and global BA (optim/global_ba.py) against the JAX package's, on
tests/test_ba.py's scene and on tests/test_global_ba.py's map, converted.

Tolerances: one CG solve on the same blocks within 1e-4 relative to the
step's size (40 float32 CG iterations); bundle_adjust with solver="cg"
within 1e-4 (poses) and 1e-3 (landmarks) and the same inlier mask; global
BA on a converted map within 1e-3 (poses, landmarks) with the same
unbound observations and inlier count.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu.optim import ba_core as jba
from orb_slam3_vio_fixes_tpu.optim import global_ba as jgba
from orb_slam3_vio_fixes_tpu_torch import convert
from orb_slam3_vio_fixes_tpu_torch.optim import ba_core as tba
from orb_slam3_vio_fixes_tpu_torch.optim import global_ba as tgba
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera as TCamera

from test_ba import BF, CAM, make_scene, perturb
from test_global_ba import _build_map, _perturb_map

torch.set_num_threads(2)

TCAM = TCamera.pinhole(CAM.fx, CAM.fy, CAM.cx, CAM.cy)


def T(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _problems(seed, outlier_frac=0.0, stereo=True):
    rng = np.random.default_rng(seed)
    R_gt, t_gt, pts, factors, _ = make_scene(rng, noise_px=0.3, outlier_frac=outlier_frac,
                                             stereo=stereo)
    R0, t0 = perturb(rng, R_gt, t_gt, 0.02, 0.05)
    R0[0], t0[0] = R_gt[0], t_gt[0]
    lm0 = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    P, L = len(R0), len(pts)
    fixed = np.zeros(P, bool)
    fixed[0] = True
    jp = jba.BAProblem(R=jnp.asarray(R0), t=jnp.asarray(t0), pose_fixed=jnp.asarray(fixed),
                       lm=jnp.asarray(lm0), lm_valid=jnp.ones(L, bool),
                       lm_fixed=jnp.zeros(L, bool), factors=factors, cam=CAM, bf=BF)
    tf = tba.ReprojFactors(T(factors.pose_idx, torch.int64), T(factors.lm_idx, torch.int64),
                           T(factors.uvr), T(factors.inv_sigma2), T(factors.valid))
    tp = tba.BAProblem(R=T(R0), t=T(t0), pose_fixed=T(fixed), lm=T(lm0),
                       lm_valid=torch.ones(L, dtype=torch.bool),
                       lm_fixed=torch.zeros(L, dtype=torch.bool), factors=tf, cam=TCAM,
                       bf=float(BF))
    return jp, tp


@pytest.mark.parametrize("seed", [0, 3])
def test_schur_cg_solve_same_blocks(seed):
    jp, tp = _problems(seed)
    inl = jnp.ones(jp.factors.valid.shape[0], bool)
    cfg = jba.LMConfig(solver="cg")
    Hpl_f, Hpp, Hll, bp, bl, _ = jba._factor_blocks(jp, inl, cfg)
    Hpp_d, Hll_inv, lm_active, free = jba._damped_blocks(Hpp, Hll, jp.pose_fixed,
                                                         jnp.float32(1e-3))
    pidx, lidx = jp.factors.pose_idx, jp.factors.lm_idx
    jdx = jba.schur_cg_solve(Hpl_f, Hpp_d, Hll_inv, bp, bl, pidx, lidx, free, 40)
    jdl = jba.backsub_landmarks(Hpl_f, Hll_inv, bl, jdx, pidx, lidx, ~lm_active)
    args = [T(a) for a in (Hpl_f, Hpp_d, Hll_inv, bp, bl)]
    ti, tl = T(pidx, torch.int64), T(lidx, torch.int64)
    tdx = tba.schur_cg_solve(*args, ti, tl, T(free), 40)
    tdl = tba.backsub_landmarks(args[0], args[2], args[4], tdx, ti, tl, T(~lm_active))
    scale = float(np.abs(np.asarray(jdx)).max())
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), atol=1e-4 * scale)
    np.testing.assert_allclose(tdl.numpy(), np.asarray(jdl),
                               atol=1e-4 * float(np.abs(np.asarray(jdl)).max()))
    # and the port's block assembly matches the reference's
    tblocks = tba._factor_blocks(tp, torch.ones(tp.factors.valid.shape[0], dtype=torch.bool),
                                 tba.LMConfig(solver="cg"))
    for a, b in zip(tblocks, (Hpl_f, Hpp, Hll, bp, bl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(np.asarray(b)).max()))


@pytest.mark.parametrize("stereo", [True, False])
@pytest.mark.parametrize("outlier_frac", [0.0, 0.05])
def test_bundle_adjust_cg(outlier_frac, stereo):
    jp, tp = _problems(1, outlier_frac, stereo)
    cfg = dict(solver="cg", cg_iters=40, n_rounds=2, n_iters=6)
    jo, jin, _ = jba.bundle_adjust(jp, jba.LMConfig(**cfg))
    to, tin, _ = tba.bundle_adjust(tp, tba.LMConfig(**cfg))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    np.testing.assert_allclose(to.R.numpy(), np.asarray(jo.R), atol=1e-4)
    np.testing.assert_allclose(to.t.numpy(), np.asarray(jo.t), atol=1e-4)
    np.testing.assert_allclose(to.lm.numpy(), np.asarray(jo.lm), atol=1e-3)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("noise", [0.0, 0.2])
def test_run_global_ba_converted_map(noise, seed):
    rng = np.random.default_rng(seed)
    state, R_gt, t_gt, pts = _build_map(rng, noise=noise)
    if noise:
        kf_uv = np.array(state.kf_uv)
        kf_uv[2, :20] += 50.0
        state = state._replace(kf_uv=jnp.asarray(kf_uv))
    noisy = _perturb_map(rng, state)
    fields = {f: np.array(getattr(noisy, f), copy=True) for f in noisy._fields}
    tstate = convert.map_state_from_numpy(fields, "cpu")
    jout, jn = jgba.run_global_ba(noisy, jnp.ones(4, jnp.float32), CAM, BF, jnp.int32(0),
                                  n_levels=4)
    tout, tn = tgba.run_global_ba(tstate, torch.ones(4), TCAM, float(BF), 0, n_levels=4)
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tout.kf_obs.numpy(), np.asarray(jout.kf_obs))
    for f in ("kf_R", "kf_t", "lm_pos"):
        np.testing.assert_allclose(getattr(tout, f).numpy(), np.asarray(getattr(jout, f)),
                                   atol=1e-3, err_msg=f)
    if noise:   # test_global_ba's bars for each case
        assert (tout.kf_obs[2, :20].numpy() < 0).mean() > 0.8
    else:
        C = -np.einsum("kji,kj->ki", tout.kf_R.numpy(), tout.kf_t.numpy())
        assert np.abs(C - (-np.einsum("kji,kj->ki", R_gt, t_gt))).max() < 1e-2
