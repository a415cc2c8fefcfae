"""Global bundle adjustment over the whole map (port of
orb_slam3_vio_fixes_tpu/optim/global_ba.py).

Every valid keyframe is a pose vertex and every bound observation a factor;
the matrix-free CG Schur solver (ba_core, solver="cg") keeps memory
O(F + K + L). Landmarks seen by fewer than two keyframes are held fixed and
their factors left out; observations that end as outliers are unbound.
"""

from __future__ import annotations

import torch

from orb_slam3_vio_fixes_tpu_torch.optim import ba_core
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera

GBA_CONFIG = ba_core.LMConfig(n_rounds=2, n_iters=8, solver="cg", cg_iters=40)


def run_global_ba(state: ms.MapState, inv_sigma2_oct, cam: Camera, bf: float,
                  fixed_kf: int = 0, cfg: ba_core.LMConfig = GBA_CONFIG,
                  n_levels: int = 8, scale: float = 1.2):
    """Optimise every valid keyframe pose and landmark jointly. Returns
    (state', n_inlier_factors as a 0-dim tensor); the state is a new tuple
    (its untouched fields shared with the input)."""
    K, N = state.kf_obs.shape
    window = torch.arange(K, device=state.kf_obs.device)
    pose_idx, lm_idx, uvr, inv_s2, valid = ms.ba_factors_from_map(
        state, window, inv_sigma2_oct)
    n_obs = ms.landmark_obs_count(state)
    valid = valid & (n_obs[lm_idx] >= 2)
    pose_fixed = ~state.kf_valid
    pose_fixed[int(fixed_kf)] = True
    problem = ba_core.BAProblem(
        R=state.kf_R, t=state.kf_t, pose_fixed=pose_fixed, lm=state.lm_pos,
        lm_valid=state.lm_valid, lm_fixed=n_obs < 2,
        factors=ba_core.ReprojFactors(pose_idx, lm_idx, uvr, inv_s2, valid),
        cam=cam, bf=bf)
    out, inlier, _ = ba_core.bundle_adjust(problem, cfg)
    upd = state.kf_valid & ~pose_fixed
    drop = (valid & ~inlier).reshape(K, N)
    new_state = state._replace(
        kf_R=torch.where(upd[:, None, None], out.R, state.kf_R),
        kf_t=torch.where(upd[:, None], out.t, state.kf_t),
        lm_pos=out.lm, kf_obs=torch.where(drop, torch.full_like(state.kf_obs, -1),
                                          state.kf_obs),
        epoch=state.epoch + 1)
    new_state = ms.update_landmark_stats(new_state, n_levels, scale)
    return new_state, (valid & inlier).sum()
