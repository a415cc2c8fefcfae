"""Full-map visual-inertial bundle adjustment with a matrix-free CG Schur
solve (port of the single-device part of
orb_slam3_vio_fixes_tpu/optim/vi_global_ba.py; the landmark-sharded variant
waits for the multi-device slice).

One 15-DoF state per keyframe slot. Landmarks are Schur-eliminated; the
reduced system carries the IMU chain's 15x15 diagonal and off-diagonal
blocks, applied factor-wise inside the CG matvec, so S is never formed.
Fixed iteration counts and `torch.where` selection: no host sync inside.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_vio_fixes_tpu_torch.imu import preintegration as pre
from orb_slam3_vio_fixes_tpu_torch.optim import vi_ba
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera
from orb_slam3_vio_fixes_tpu_torch.utils.linalg import compact_indices, index_add_rows, inv3

D = vi_ba.D


class VIGBAConfig(NamedTuple):
    n_rounds: int = 2
    n_iters: int = 6
    cg_iters: int = 40
    chi2_mono: float = 5.991
    chi2_stereo: float = 7.815
    huber_inertial: float = 16.92
    lambda0: float = 1e-4
    # per-keyframe prior pulling the biases toward their entry values (a fresh
    # map's biases are barely observable per keyframe)
    bias_prior: float = 1e2


def _body_states(state: ms.MapState, R_cb, t_cb):
    return vi_ba.body_from_cam(state.kf_R, state.kf_t, R_cb, t_cb)


def _cam_states(R_wb, p_wb, R_cb, t_cb):
    return vi_ba.cam_from_body(R_wb, p_wb, R_cb, t_cb)


def _wJ(J, w):
    return J * w[:, None, None]


def _reproj_blocks(R_wb, p_wb, lm, factors: vi_ba.VIReprojFactors, cam: Camera, bf,
                   R_cb, t_cb, pose_fixed, lm_fixed, inlier, cfg: VIGBAConfig):
    """Per-factor Gauss-Newton blocks of the reprojection term in body-state
    perturbation coordinates. Returns (Hpl_f (F, 6, 3), Hpp (K, 6, 6),
    Hll (L, 3, 3), bp (K, 6), bl (L, 3), chi2 (F,))."""
    K, L, dev = R_wb.shape[0], lm.shape[0], lm.device
    pidx, lidx = factors.state_idx, factors.lm_idx
    is_stereo = factors.uvr[:, 2] >= 0.0
    zero = torch.zeros((), device=dev)
    row = torch.stack([torch.ones_like(is_stereo), torch.ones_like(is_stereo),
                       is_stereo], -1)
    r0, Jp, Jl = vi_ba.reproj_jacobians(R_wb[pidx], p_wb[pidx], lm[lidx], factors.uvr,
                                        cam, bf, R_cb, t_cb)
    r0 = torch.where(row, r0, zero)
    Jp = torch.where(row[..., None], Jp, zero)
    Jl = torch.where(row[..., None], Jl, zero)
    chi2 = factors.inv_sigma2 * (r0 * r0).sum(-1)
    delta2 = torch.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono).to(torch.float32)
    w = factors.inv_sigma2 * vi_ba.huber_w(chi2, delta2)
    w = torch.where(factors.valid & inlier, w, zero)
    Jp = torch.where(pose_fixed[pidx][:, None, None], zero, Jp)
    Jl = torch.where(lm_fixed[lidx][:, None, None], zero, Jl)
    act = w > 0
    Jp = torch.where(act[:, None, None], Jp, zero)
    Jl = torch.where(act[:, None, None], Jl, zero)
    r0 = torch.where(act[:, None], r0, zero)
    wJp, wJl = _wJ(Jp, w), _wJ(Jl, w)
    Hpp = index_add_rows(torch.zeros((K, 6, 6), device=dev), pidx,
                         wJp.transpose(1, 2) @ Jp)
    Hll = index_add_rows(torch.zeros((L, 3, 3), device=dev), lidx,
                         wJl.transpose(1, 2) @ Jl)
    Hpl_f = wJp.transpose(1, 2) @ Jl
    bp = index_add_rows(torch.zeros((K, 6), device=dev), pidx,
                        -(wJp.transpose(1, 2) @ r0[..., None])[..., 0])
    bl = index_add_rows(torch.zeros((L, 3), device=dev), lidx,
                        -(wJl.transpose(1, 2) @ r0[..., None])[..., 0])
    return Hpl_f, Hpp, Hll, bp, bl, chi2


def _imu_blocks(R_wb, p_wb, v, bg, ba, inertial: vi_ba.VIInertialFactors, pose_fixed,
                cfg: VIGBAConfig):
    """IMU chain + bias random-walk blocks in 15-DoF state space. Returns
    (Hii, Hjj, Hij (P, 15, 15), bi, bj (P, 15), chi2 (P,)); fixed states'
    rows and columns are zero."""
    i, j = inertial.idx_i, inertial.idx_j
    dev = R_wb.device
    zero = torch.zeros((), device=dev)
    r9, J9 = vi_ba.inertial_jacobians(
        R_wb[i], p_wb[i], v[i], bg[i], ba[i], R_wb[j], p_wb[j], v[j], bg[j], ba[j],
        inertial.dT, inertial.dR, inertial.dV, inertial.dP, inertial.JRg, inertial.JVg,
        inertial.JVa, inertial.JPg, inertial.JPa, inertial.bg0, inertial.ba0)
    rw = torch.cat([bg[j] - bg[i], ba[j] - ba[i]], -1)
    J6 = vi_ba.bias_rw_jacobian(dev).expand(i.shape[0], 6, 2 * D)
    W9 = inertial.info
    chi2 = (r9[:, None, :] @ W9 @ r9[..., None])[:, 0, 0]
    W9 = vi_ba.huber_w(chi2, torch.full((), cfg.huber_inertial, device=dev))[
        :, None, None] * W9
    W6 = inertial.info_rw
    ok = inertial.valid
    oi = (ok & ~pose_fixed[i])[:, None, None]
    oj = (ok & ~pose_fixed[j])[:, None, None]
    Ji = torch.where(oi, J9[..., :D], zero)
    Jj = torch.where(oj, J9[..., D:], zero)
    Jri = torch.where(oi, J6[..., :D], zero)
    Jrj = torch.where(oj, J6[..., D:], zero)
    r9 = torch.where(ok[:, None], r9, zero)
    rw = torch.where(ok[:, None], rw, zero)
    T = lambda A: A.transpose(1, 2)  # noqa: E731
    mv = lambda A, x: (A @ x[..., None])[..., 0]  # noqa: E731
    Hii = T(Ji) @ W9 @ Ji + T(Jri) @ W6 @ Jri
    Hjj = T(Jj) @ W9 @ Jj + T(Jrj) @ W6 @ Jrj
    Hij = T(Ji) @ W9 @ Jj + T(Jri) @ W6 @ Jrj
    bi = -(mv(T(Ji) @ W9, r9) + mv(T(Jri) @ W6, rw))
    bj = -(mv(T(Jj) @ W9, r9) + mv(T(Jrj) @ W6, rw))
    return Hii, Hjj, Hij, bi, bj, chi2 * ok


def _vi_gba_solve(x, factors: vi_ba.VIReprojFactors, inertial: vi_ba.VIInertialFactors,
                  pose_fixed, lm_fixed, bg_ref, ba_ref, cam, bf, R_cb, t_cb,
                  cfg: VIGBAConfig):
    """The LM / CG loop. x = (R_wb, p_wb, v, bg, ba, lm). Returns (x',
    inlier)."""
    K = x[0].shape[0]
    L = x[5].shape[0]
    dev = x[0].device
    zero = torch.zeros((), device=dev)
    pose_idx, lm_idx = factors.state_idx, factors.lm_idx
    ii, jj = inertial.idx_i, inertial.idx_j
    is_stereo = factors.uvr[:, 2] >= 0.0
    delta2 = torch.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono).to(torch.float32)
    inlier = torch.ones(pose_idx.shape[0], dtype=torch.bool, device=dev)
    free = ~pose_fixed
    eye15 = torch.eye(D, device=dev)
    eye3 = torch.eye(3, device=dev)

    def where_x(c, a, b):
        return tuple(torch.where(c, u, w) for u, w in zip(a, b))

    def robust(chi2_f, chi2_imu, inl):
        return (torch.where(factors.valid & inl, torch.minimum(chi2_f, 4.0 * delta2),
                            zero).sum()
                + torch.clamp(chi2_imu, max=4.0 * cfg.huber_inertial).sum())

    def reproj_chi2(xx, inl):
        R_wb, p_wb, _, _, _, lm = xx
        return _reproj_blocks(R_wb, p_wb, lm, factors, cam, bf, R_cb, t_cb, pose_fixed,
                              lm_fixed, inl, cfg)[-1]

    def scatter6(q):
        return index_add_rows(torch.zeros((K, 6), device=dev), pose_idx, q)

    def scatterL(u):
        return index_add_rows(torch.zeros((L, 3), device=dev), lm_idx, u)

    def mv(A, v):
        return (A @ v[..., None])[..., 0]

    def mtv(A, v):
        return (A.transpose(-1, -2) @ v[..., None])[..., 0]

    for _ in range(cfg.n_rounds):
        x_best = x
        chi2_best = torch.full((), 1e30, device=dev)
        lam = torch.full((), cfg.lambda0, device=dev)
        for _ in range(cfg.n_iters):
            # chi2-guarded LM: a step that worsens the robustified error is
            # rejected, the state returns to the best seen, damping rises
            R_wb, p_wb, v, bg, ba, lm = x
            Hpl_f, Hpp6, Hll, bp6, bl, chi2_f = _reproj_blocks(
                R_wb, p_wb, lm, factors, cam, bf, R_cb, t_cb, pose_fixed, lm_fixed,
                inlier, cfg)
            Hii, Hjj, Hij, bi, bj, chi2_imu = _imu_blocks(
                R_wb, p_wb, v, bg, ba, inertial, pose_fixed, cfg)
            chi2_x = robust(chi2_f, chi2_imu, inlier)
            good = chi2_x <= chi2_best
            x_best = where_x(good, x, x_best)
            chi2_best = torch.minimum(chi2_x, chi2_best)
            lam = torch.where(good, lam * 0.7, lam * 4.0)
            Hpp = torch.zeros((K, D, D), device=dev)
            Hpp[:, :6, :6] = Hpp6
            Hpp.index_add_(0, ii, Hii).index_add_(0, jj, Hjj)
            bp = torch.zeros((K, D), device=dev)
            bp[:, :6] = bp6
            bp.index_add_(0, ii, bi).index_add_(0, jj, bj)
            if cfg.bias_prior > 0:
                wb = cfg.bias_prior
                Hpp[:, 9:15, 9:15] += torch.eye(6, device=dev) * wb
                bp[:, 9:12] += -wb * (bg - bg_ref)
                bp[:, 12:15] += -wb * (ba - ba_ref)
            Hpp_d = Hpp + lam * Hpp * eye15 + 1e-8 * eye15
            Hll_d = Hll + lam * Hll * eye3
            lm_active = Hll_d.abs().sum((-1, -2)) > 1e-12
            Hll_d = torch.where(lm_active[:, None, None], Hll_d, eye3)
            mu = 1e-3 * (Hll_d[:, 0, 0] + Hll_d[:, 1, 1] + Hll_d[:, 2, 2]) / 3.0 + 1e-8
            Hll_inv = inv3(Hll_d + mu[:, None, None] * eye3)

            def matvec(vv):
                vv = torch.where(free[:, None], vv, zero)
                Sv = mv(Hpp_d, vv)
                y = scatterL(mtv(Hpl_f, vv[pose_idx, :6]))
                Sv[:, :6] -= scatter6(mv(Hpl_f, mv(Hll_inv, y)[lm_idx]))
                Sv.index_add_(0, ii, mv(Hij, vv[jj])).index_add_(0, jj, mtv(Hij, vv[ii]))
                return torch.where(free[:, None], Sv, zero)

            rhs = bp.clone()
            rhs[:, :6] -= scatter6(mv(Hpl_f, mv(Hll_inv, bl)[lm_idx]))
            rhs = torch.where(free[:, None], rhs, zero)
            diag_ok = (Hpp_d.abs().sum((-1, -2)) > 1e-9) & free
            Minv = torch.linalg.inv_ex(torch.where(diag_ok[:, None, None], Hpp_d,
                                                   eye15))[0]
            xx = torch.zeros_like(rhs)
            r = rhs
            z = mv(Minv, r)
            p = z
            rz = (r * z).sum()
            for _ in range(cfg.cg_iters):
                Ap = matvec(p)
                pAp = (p * Ap).sum()
                okc = (pAp > 1e-20) & (rz > 1e-20)
                alpha = torch.where(okc, rz / torch.where(okc, pAp, 1.0), zero)
                xx = xx + alpha * p
                r = r - alpha * Ap
                z = mv(Minv, r)
                rz_new = (r * z).sum()
                beta = torch.where(okc, rz_new / torch.where(rz > 1e-20, rz, 1.0), zero)
                p = z + beta * p
                rz = rz_new
            dx = torch.where(free[:, None], xx, zero)
            y = scatterL(mtv(Hpl_f, dx[pose_idx, :6]))
            dlm = mv(Hll_inv, bl - y)
            dlm = torch.where((lm_fixed | ~lm_active)[:, None], zero, dlm)
            x2 = (*vi_ba.apply_eps(R_wb, p_wb, v, bg, ba, dx), lm + dlm)
            # a rejected step restarts from the best state
            x = where_x(good, x2, x_best)
        # the last candidate was stepped but never evaluated: keep the better
        chi2_imu = _imu_blocks(*x[:5], inertial, pose_fixed, cfg)[-1]
        chi2_last = robust(reproj_chi2(x, inlier), chi2_imu, inlier)
        x = where_x(chi2_last <= chi2_best, x, x_best)
        inlier = reproj_chi2(x, inlier) <= delta2
    return x, inlier


def run_global_vi_ba(state: ms.MapState, inertial: vi_ba.VIInertialFactors,
                     inv_sigma2_oct: torch.Tensor, cam: Camera, bf,
                     calib: pre.ImuCalib, pose_fixed_in: torch.Tensor,
                     cfg: VIGBAConfig = VIGBAConfig(), n_levels: int = 8,
                     scale: float = 1.2, f_budget: int | None = None,
                     lm_budget: int | None = None):
    """Joint 15-DoF keyframe + landmark optimisation over the whole map
    (reference: FullInertialBA). `pose_fixed_in` picks the keyframes that
    stay; f_budget / lm_budget compact the factor table and the landmark
    axis first. Updates `state` in place and returns (state,
    n_inlier_factors).

    Unlike the reference, the compacted landmark write-back goes through an
    (L + 1)-row buffer: its pad slots point at landmark 0 and would revert
    that landmark's update."""
    K, N = state.kf_obs.shape
    L = state.lm_pos.shape[0]
    dev = state.kf_R.device
    R_cb, t_cb = calib.cam_from_body()
    window = torch.arange(K, device=dev)
    pose_idx, lm_idx, uvr, inv_s2, valid = ms.ba_factors_from_map(
        state, window, inv_sigma2_oct)
    n_obs = ms.landmark_obs_count(state)
    valid = valid & (n_obs[lm_idx] >= 2)
    F_full = pose_idx.shape[0]
    order = None
    if f_budget is not None and f_budget < F_full:
        order, order_ok = compact_indices(valid, f_budget)
        pose_idx, lm_idx = pose_idx[order], lm_idx[order]
        uvr, inv_s2 = uvr[order], inv_s2[order]
        valid = valid[order] & order_ok
    pose_fixed = pose_fixed_in | ~state.kf_valid
    lm_fixed_full = (n_obs < 2) | ~state.lm_valid
    sub_idx = None
    if lm_budget is not None and lm_budget < L:
        used = ms.set_masked(torch.zeros(L, dtype=torch.bool, device=dev), lm_idx,
                             valid, True)
        sub_idx, sub_ok = compact_indices(used, lm_budget)
        remap = torch.full((L + 1,), -1, dtype=torch.int64, device=dev)
        remap[torch.where(sub_ok, sub_idx, torch.full_like(sub_idx, L))] = torch.arange(
            lm_budget, device=dev)
        lm_local = remap[:L][lm_idx]
        valid = valid & (lm_local >= 0)
        lm_idx = lm_local.clamp(0, lm_budget - 1)
        lm_fixed = lm_fixed_full[sub_idx] | ~sub_ok
        lm0 = state.lm_pos[sub_idx]
    else:
        lm_fixed = lm_fixed_full
        lm0 = state.lm_pos
    factors = vi_ba.VIReprojFactors(pose_idx, lm_idx, uvr, inv_s2, valid)
    R_wb, p_wb = _body_states(state, R_cb, t_cb)
    x = (R_wb, p_wb, state.kf_vel, state.kf_bg, state.kf_ba, lm0)
    x, inlier = _vi_gba_solve(x, factors, inertial, pose_fixed, lm_fixed,
                              state.kf_bg, state.kf_ba, cam, bf, R_cb, t_cb, cfg)
    R_wb, p_wb, v, bg, ba, lm = x
    kf_R, kf_t = _cam_states(R_wb, p_wb, R_cb, t_cb)
    upd = state.kf_valid & ~pose_fixed
    if sub_idx is not None:
        ext = torch.cat([state.lm_pos, state.lm_pos[:1]])
        ext[torch.where(sub_ok & ~lm_fixed, sub_idx, torch.full_like(sub_idx, L))] = lm
        new_lm = ext[:L]
    else:
        new_lm = torch.where(lm_fixed[:, None], state.lm_pos, lm)
    state.lm_pos.copy_(new_lm)
    state.kf_R.copy_(torch.where(upd[:, None, None], kf_R, state.kf_R))
    state.kf_t.copy_(torch.where(upd[:, None], kf_t, state.kf_t))
    state.kf_vel.copy_(torch.where(upd[:, None], v, state.kf_vel))
    state.kf_bg.copy_(torch.where(upd[:, None], bg, state.kf_bg))
    state.kf_ba.copy_(torch.where(upd[:, None], ba, state.kf_ba))
    n_inl = (valid & inlier).sum()
    if order is not None:
        # un-compact the outlier mask back to the (K * N) table layout
        slot = torch.where(order_ok, order, torch.full_like(order, F_full))
        inlier_full = torch.ones(F_full + 1, dtype=torch.bool, device=dev)
        inlier_full[slot] = inlier | ~valid
        valid_full = torch.zeros(F_full + 1, dtype=torch.bool, device=dev)
        valid_full[slot] = valid
        drop = (valid_full[:F_full] & ~inlier_full[:F_full]).reshape(K, N)
    else:
        drop = (valid & ~inlier).reshape(K, N)
    state.kf_obs.copy_(torch.where(drop, torch.full_like(state.kf_obs, -1), state.kf_obs))
    state = ms.update_landmark_stats(state._replace(epoch=state.epoch + 1), n_levels, scale)
    return state, n_inl
