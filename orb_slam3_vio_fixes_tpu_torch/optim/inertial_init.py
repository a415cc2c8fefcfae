"""Inertial-only optimisation: gravity direction, scale, biases, velocities
(port of orb_slam3_vio_fixes_tpu/optim/inertial_init.py).

One flattened parameter vector x = [v_0..v_{K-1} (3K), bg (3), ba (3),
theta_g (2), log_s (1)]; residuals are the 9-dim preintegration factors
between keyframe pairs plus the bias priors. The reference differentiates the
whole residual with `jacfwd` over all 3K+9 parameters. A pair's residual
depends on 15 of them (v_i, v_j, bg, ba, theta, log_s), so here the pairs'
(9, 15) blocks come from one forward-mode pass over 15 tangents
(`utils.autodiff.jac_rows`) and are scattered into the dense Jacobian: the
same derivatives, 15 tangents instead of 3K+9.
The damped normal equations are solved by Cholesky, as `solve(assume_a=
"pos")` does; 60 LM iterations with `torch.where` accept/reject, no sync.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam3_vio_fixes_tpu_torch.imu import preintegration as pre
from orb_slam3_vio_fixes_tpu_torch.utils import lie
from orb_slam3_vio_fixes_tpu_torch.utils.autodiff import jac_rows


class InertialInitFactors(NamedTuple):
    """Per keyframe-pair preintegration data, padded to P pairs."""

    idx_i: torch.Tensor     # (P,) int64
    idx_j: torch.Tensor
    dT: torch.Tensor        # (P,)
    dR: torch.Tensor        # (P, 3, 3)
    dV: torch.Tensor
    dP: torch.Tensor
    JRg: torch.Tensor
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    info: torch.Tensor      # (P, 9, 9)
    bg0: torch.Tensor
    ba0: torch.Tensor
    valid: torch.Tensor     # (P,) bool


def eig_fn(M: torch.Tensor, fn) -> torch.Tensor:
    """V diag(fn(lambda)) V^T of symmetric (..., n, n) matrices."""
    val, vec = torch.linalg.eigh(M)
    return (vec * fn(val)[..., None, :]) @ vec.transpose(-1, -2)


def information_from_cov(cov: torch.Tensor, eig_floor: float = 1e-12) -> torch.Tensor:
    """Symmetrise and pseudo-invert with eigenvalue clamping (reference:
    EdgeInertial's constructor)."""
    sym = 0.5 * (cov + cov.transpose(-1, -2))
    return eig_fn(sym, lambda v: torch.where(
        v > eig_floor, 1.0 / torch.clamp(v, min=eig_floor), torch.zeros_like(v)))


def factors_from_preintegrations(idx_i, idx_j, pres: pre.Preintegrated,
                                 valid) -> InertialInitFactors:
    dev = pres.dT.device
    return InertialInitFactors(
        idx_i=torch.as_tensor(np.asarray(idx_i), dtype=torch.int64, device=dev),
        idx_j=torch.as_tensor(np.asarray(idx_j), dtype=torch.int64, device=dev),
        dT=pres.dT, dR=pres.dR, dV=pres.dV, dP=pres.dP, JRg=pres.JRg,
        JVg=pres.JVg, JVa=pres.JVa, JPg=pres.JPg, JPa=pres.JPa,
        info=information_from_cov(pres.cov), bg0=pres.bg0, ba0=pres.ba0,
        valid=torch.as_tensor(np.asarray(valid), dtype=torch.bool, device=dev))


def _gravity_rot(theta: torch.Tensor) -> torch.Tensor:
    """R_wg = exp([tx, ty, 0]^) (reference: VertexGDir's update)."""
    return lie.so3_exp(torch.cat([theta, torch.zeros_like(theta[..., :1])], -1))


def _gravity(theta: torch.Tensor) -> torch.Tensor:
    return _mv(_gravity_rot(theta), pre.gravity_vec(theta.device, theta.dtype))


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _pair_residual(v1, v2, bg, ba, theta, log_s, R1, p1, R2, p2,
                   f_dT, f_dR, f_dV, f_dP, f_JRg, f_JVg, f_JVa, f_JPg, f_JPa,
                   f_bg0, f_ba0):
    """(B, 9) residuals (er, ev, ep) of a batch of preintegration factors."""
    g = _gravity(theta)
    s = torch.exp(log_s)[:, None]
    dt = f_dT[:, None]
    dbg = bg - f_bg0
    dba = ba - f_ba0
    dR = f_dR @ lie.so3_exp(_mv(f_JRg, dbg))
    dV = f_dV + _mv(f_JVg, dbg) + _mv(f_JVa, dba)
    dP = f_dP + _mv(f_JPg, dbg) + _mv(f_JPa, dba)
    R1T = R1.transpose(-1, -2)
    er = lie.so3_log(dR.transpose(-1, -2) @ R1T @ R2)
    ev = _mv(R1T, s * (v2 - v1) - g * dt) - dV
    ep = _mv(R1T, s * (p2 - p1 - v1 * dt) - 0.5 * g * dt * dt) - dP
    return torch.cat([er, ev, ep], -1)


class InertialInitConfig(NamedTuple):
    n_iters: int = 30
    prior_gyro: float = 1e2
    prior_acc: float = 1e10
    fix_scale: bool = True
    lambda0: float = 1e-4
    fix_bias: bool = False
    fix_vel: bool = False
    # visual-noise floor of the whitening (errors-in-variables guard of the
    # free-scale mode; see the reference's InertialInitConfig)
    sigma_vis_rot: float = 0.0
    sigma_vis_pos: float = 0.0


def inertial_optimization(R_wb, p_wb, v0, factors: InertialInitFactors,
                          cfg: InertialInitConfig = InertialInitConfig(),
                          bg_init=None, ba_init=None, scale_init=None):
    """Poses fixed; velocities, one shared bias pair, the 2-DoF gravity
    direction and (free-scale mode) the log-scale adjust.
    Returns (v, bg, ba, Rwg, scale, chi2_history (n_iters,))."""
    K = R_wb.shape[0]
    P = factors.idx_i.shape[0]
    n = 3 * K + 9
    dev = R_wb.device
    f32 = torch.float32
    eig = cfg.sigma_vis_rot > 0.0 or cfg.sigma_vis_pos > 0.0
    if eig:
        # whitening: the diagonal covariance (the pairs' first row argument)
        white = torch.diagonal(torch.linalg.inv_ex(
            factors.info + 1e-12 * torch.eye(9, device=dev))[0], dim1=-2, dim2=-1)
        floor = torch.tensor([2.0 * cfg.sigma_vis_rot ** 2] * 3 + [0.0] * 6,
                             device=dev)
        pos_w = torch.tensor([0.0] * 6 + [2.0] * 3, device=dev)
    else:
        white = eig_fn(factors.info, lambda v: torch.sqrt(torch.clamp(v, min=0.0)))
    ii, jj = factors.idx_i, factors.idx_j
    pair_rows = (white, R_wb[ii], p_wb[ii], R_wb[jj], p_wb[jj], factors.dT, factors.dR,
                 factors.dV, factors.dP, factors.JRg, factors.JVg, factors.JVa,
                 factors.JPg, factors.JPa, factors.bg0, factors.ba0)

    def pair_white(loc, white, *pair_const):
        """Whitened residuals of the pairs as a function of their 15 local
        parameters each: [v_i, v_j, bg, ba, theta, log_s]."""
        r = _pair_residual(loc[:, 0:3], loc[:, 3:6], loc[:, 6:9], loc[:, 9:12],
                           loc[:, 12:14], loc[:, 14], *pair_const)
        if eig:
            s = torch.exp(loc[:, 14:15])
            return r / torch.sqrt(white + floor + pos_w * (s * cfg.sigma_vis_pos) ** 2)
        return _mv(white, r)
    ar3 = torch.arange(3, device=dev)
    # global column of each local parameter, per pair: (P, 15)
    cols = torch.cat([3 * ii[:, None] + ar3, 3 * jj[:, None] + ar3,
                      (3 * K + torch.arange(9, device=dev)).expand(P, 9)], 1)
    valid_r = factors.valid[:, None]
    sq_g = float(np.float32(np.sqrt(cfg.prior_gyro)))
    sq_a = float(np.float32(np.sqrt(cfg.prior_acc)))
    prior_J = torch.zeros((6, n), device=dev)
    prior_J[torch.arange(6, device=dev), 3 * K + torch.arange(6, device=dev)] = torch.tensor(
        [sq_g] * 3 + [sq_a] * 3, device=dev)

    def local(x):
        v = x[:3 * K].reshape(K, 3)
        shared = x[3 * K:].expand(P, 9)
        return torch.cat([v[ii], v[jj], shared], 1)

    def full_residual(x):
        r = torch.where(valid_r, pair_white(local(x), *pair_rows),
                        torch.zeros((), device=dev))
        return torch.cat([r.reshape(-1), sq_g * x[3 * K:3 * K + 3],
                          sq_a * x[3 * K + 3:3 * K + 6]])

    dof = torch.ones(n, device=dev)
    if cfg.fix_scale:
        dof[-1] = 0.0
    if cfg.fix_vel:
        dof[:3 * K] = 0.0
    if cfg.fix_bias:
        dof[3 * K:3 * K + 6] = 0.0

    zero3 = torch.zeros(3, device=dev)
    bg0x = zero3 if bg_init is None else bg_init.to(f32)
    ba0x = zero3 if ba_init is None else ba_init.to(f32)
    ls0 = (torch.zeros(1, device=dev) if scale_init is None else torch.log(
        torch.clamp(torch.as_tensor(scale_init, dtype=f32, device=dev).reshape(1),
                    min=1e-6)))
    x = torch.cat([v0.reshape(-1).to(f32), bg0x, ba0x, torch.zeros(2, device=dev), ls0])
    lam = torch.full((), cfg.lambda0, device=dev)
    chi2 = []
    for _ in range(cfg.n_iters):
        r = full_residual(x)
        Jp = torch.where(valid_r[..., None], jac_rows(pair_white, local(x), *pair_rows)[1],
                         torch.zeros((), device=dev))
        J = torch.zeros((P, 9, n), device=dev).scatter_add_(
            2, cols[:, None, :].expand(P, 9, 15), Jp)
        J = torch.cat([J.reshape(P * 9, n), prior_J]) * dof
        H = J.T @ J
        b = -(J.T @ r)
        damp = torch.where(dof > 0, lam * torch.clamp(torch.diagonal(H), min=1e-6),
                           torch.ones((), device=dev))
        Lc, _ = torch.linalg.cholesky_ex(H + torch.diag(damp))
        dx = torch.cholesky_solve(b[:, None], Lc)[:, 0] * dof
        x_new = x + dx
        c_old = (r * r).sum()
        r_new = full_residual(x_new)
        ok = (r_new * r_new).sum() < c_old
        x = torch.where(ok, x_new, x)
        lam = torch.where(ok, torch.clamp(lam * 0.3, min=1e-8),
                          torch.clamp(lam * 8.0, max=1e6))
        chi2.append(c_old)
    v = x[:3 * K].reshape(K, 3)
    Rwg = _gravity_rot(x[3 * K + 6:3 * K + 8])
    return (v, x[3 * K:3 * K + 3], x[3 * K + 3:3 * K + 6], Rwg, torch.exp(x[3 * K + 8]),
            torch.stack(chi2))


def visual_inertial_alignment(R_wb, p_wb, factors: InertialInitFactors):
    """Closed-form linear alignment of velocities, gravity and scale from the
    preintegration constraints at zero bias, one least-squares solve on the
    host. Returns (v (K, 3), g (3,), s) as numpy float32 / float."""
    R = R_wb.detach().cpu().numpy().astype(np.float64)
    p = p_wb.detach().cpu().numpy().astype(np.float64)
    K = R.shape[0]
    idx_i = factors.idx_i.cpu().numpy()
    idx_j = factors.idx_j.cpu().numpy()
    valid = factors.valid.cpu().numpy()
    dT = factors.dT.cpu().numpy().astype(np.float64)
    dV = factors.dV.cpu().numpy().astype(np.float64)
    dP = factors.dP.cpu().numpy().astype(np.float64)
    n = 3 * K + 4
    rows, rhs = [], []
    for k in range(idx_i.shape[0]):
        if not valid[k]:
            continue
        i, j = int(idx_i[k]), int(idx_j[k])
        R1T = R[i].T
        dt = dT[k]
        a = np.zeros((3, n))
        a[:, 3 * i:3 * i + 3] = -R1T
        a[:, 3 * j:3 * j + 3] = R1T
        a[:, 3 * K:3 * K + 3] = -R1T * dt
        rows.append(a)
        rhs.append(dV[k])
        a = np.zeros((3, n))
        a[:, 3 * i:3 * i + 3] = -R1T * dt
        a[:, 3 * K:3 * K + 3] = -0.5 * R1T * dt * dt
        a[:, 3 * K + 3] = R1T @ (p[j] - p[i])
        rows.append(a)
        rhs.append(dP[k])
    x, *_ = np.linalg.lstsq(np.concatenate(rows), np.concatenate(rhs), rcond=None)
    return (x[:3 * K].reshape(K, 3).astype(np.float32),
            x[3 * K:3 * K + 3].astype(np.float32), float(x[3 * K + 3]))


def gravity_bootstrap(R_wb, dV, valid) -> torch.Tensor:
    """R_wg aligning the accumulated velocity deltas with -Z gravity
    (reference: the dirG bootstrap of LocalMapping::InitializeIMU)."""
    zero = torch.zeros((), dtype=dV.dtype, device=dV.device)
    dirG = -torch.where(valid[:, None], (R_wb @ dV[..., None])[..., 0], zero).sum(0)
    dirG = dirG / torch.clamp(torch.linalg.norm(dirG), min=1e-9)
    gI = torch.tensor([0.0, 0.0, -1.0], dtype=dirG.dtype, device=dirG.device)
    v = torch.linalg.cross(gI, dirG)
    nv = torch.linalg.norm(v)
    ang = torch.atan2(nv, (gI * dirG).sum())
    return lie.so3_exp(v / torch.clamp(nv, min=1e-9) * ang)


def apply_scaled_rotation(kf_R, kf_t, kf_vel, lm_pos, R_gw, scale):
    """Rotate and rescale the map into the gravity-aligned frame (reference:
    Map::ApplyScaledRotation): R_cw' = R_cw R_gw^T, t_cw' = s t_cw,
    v' = s R_gw v, x' = s R_gw x. Returns (kf_R, kf_t, kf_vel, lm_pos)."""
    return (kf_R @ R_gw.T, kf_t * scale, scale * (kf_vel @ R_gw.T),
            scale * (lm_pos @ R_gw.T))
