"""Visual-inertial bundle adjustment: 15-DoF body states, Schur landmarks
(port of orb_slam3_vio_fixes_tpu/optim/vi_ba.py).

Each window state carries (phi, p, v, bg, ba). Every factor group is a
fixed-size batch. The reference takes the Jacobians at zero perturbation
from vmapped `jacfwd`; here they are closed forms (`*_jacobians`), checked
against forward-mode autodiff of the residual functions
(`utils.autodiff.jac_rows`) in tests/test_torch_vi_ba.py: autodiff through
the SO(3) maps costs hundreds of small kernels per call on the per-frame
path. Landmarks are Schur-eliminated with the
closed-form 3x3 inverse; the reduced (15W x 15W) system is solved by one
Cholesky (`cholesky_ex`: no error check, so no host sync). The factor
functions hold no data-dependent Python branch.

Perturbation (the reference's ImuCamPose::Update): R' = R exp(eps[0:3]^),
p' = p + R eps[3:6], v' = v + eps[6:9], bg' = bg + eps[9:12],
ba' = ba + eps[12:15].
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from orb_slam3_vio_fixes_tpu_torch.imu import preintegration as pre
from orb_slam3_vio_fixes_tpu_torch.optim.inertial_init import eig_fn, information_from_cov
from orb_slam3_vio_fixes_tpu_torch.utils import lie
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera, project, project_jac
from orb_slam3_vio_fixes_tpu_torch.utils.linalg import index_add_rows, inv3

D = 15  # DoF per state


class VIStates(NamedTuple):
    R_wb: torch.Tensor   # (W, 3, 3)
    p_wb: torch.Tensor   # (W, 3)
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    fixed: torch.Tensor  # (W,) bool: all 15 DoF frozen
    valid: torch.Tensor  # (W,) bool


class VIReprojFactors(NamedTuple):
    """Reprojection factors against window states; uvr[:, 2] < 0 is mono."""

    state_idx: torch.Tensor  # (F,) int64
    lm_idx: torch.Tensor     # (F,) int64
    uvr: torch.Tensor        # (F, 3)
    inv_sigma2: torch.Tensor
    valid: torch.Tensor


def _as_dev(a, dtype, dev):
    return torch.as_tensor(a if torch.is_tensor(a) else np.asarray(a), dtype=dtype,
                           device=dev)


class VIInertialFactors(NamedTuple):
    """Preintegration factors between window states i -> j."""

    idx_i: torch.Tensor   # (P,) int64
    idx_j: torch.Tensor
    dT: torch.Tensor
    dR: torch.Tensor
    dV: torch.Tensor
    dP: torch.Tensor
    JRg: torch.Tensor
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    info: torch.Tensor      # (P, 9, 9)
    info_rw: torch.Tensor   # (P, 6, 6)
    bg0: torch.Tensor
    ba0: torch.Tensor
    valid: torch.Tensor

    @staticmethod
    def from_preintegrations(idx_i, idx_j, pres: pre.Preintegrated, valid):
        dev = pres.dT.device
        return VIInertialFactors(
            idx_i=_as_dev(idx_i, torch.int64, dev), idx_j=_as_dev(idx_j, torch.int64, dev),
            dT=pres.dT, dR=pres.dR, dV=pres.dV, dP=pres.dP, JRg=pres.JRg,
            JVg=pres.JVg, JVa=pres.JVa, JPg=pres.JPg, JPa=pres.JPa,
            info=information_from_cov(pres.cov),
            info_rw=information_from_cov(pres.cov_walk), bg0=pres.bg0, ba0=pres.ba0,
            valid=_as_dev(valid, torch.bool, dev))


class VIPrior(NamedTuple):
    """15-DoF marginal prior on one window state (`valid` is a host bool:
    an invalid prior contributes exactly zero, so it is skipped)."""

    state_idx: int
    R_wb: torch.Tensor
    p_wb: torch.Tensor
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    H: torch.Tensor       # (15, 15)
    valid: bool

    @staticmethod
    def none(device) -> "VIPrior":
        z = torch.zeros(3, device=device)
        return VIPrior(0, torch.eye(3, device=device), z, z, z, z,
                       torch.zeros((D, D), device=device), False)


class VIProblem(NamedTuple):
    """`lm` is a compacted block of the window's landmarks: the Schur
    buckets take (W, L, 15, 3)."""

    states: VIStates
    lm: torch.Tensor
    lm_valid: torch.Tensor
    lm_fixed: torch.Tensor
    reproj: VIReprojFactors
    inertial: VIInertialFactors
    prior: VIPrior
    cam: Camera
    bf: float
    R_cb: torch.Tensor
    t_cb: torch.Tensor


class VIBAConfig(NamedTuple):
    n_rounds: int = 2
    n_iters: int = 5
    chi2_mono: float = 5.991
    chi2_stereo: float = 7.815
    huber_inertial: float = 16.92
    lambda0: float = 1e-4


def _bmv(A, x):
    return (A @ x[..., None])[..., 0]


def _tr(A):
    return A.transpose(-1, -2)


# MapState holds camera poses T_cw; VI states are body-in-world (R_wb, p_wb).
# With camera-from-body extrinsics (R_cb, t_cb): R_cw = R_cb R_wb^T,
# t_cw = -R_cw p_wb + t_cb.


def body_from_cam(R_cw, t_cw, R_cb, t_cb):
    """Keyframe T_cw -> body (R_wb, p_wb), batched over leading dims:
    R_bw = R_cb^T R_cw, t_bw = R_cb^T (t_cw - t_cb), p_wb = -R_bw^T t_bw."""
    R_bw = R_cb.T @ R_cw
    t_bw = (t_cw - t_cb) @ R_cb
    R_wb = R_bw.transpose(-1, -2)
    return R_wb, -(R_wb @ t_bw[..., None])[..., 0]


def cam_from_body(R_wb, p_wb, R_cb, t_cb):
    """Body (R_wb, p_wb) -> T_cw = T_cb T_bw, batched over leading dims."""
    R_cw = R_cb @ R_wb.transpose(-1, -2)
    return R_cw, -(R_cw @ p_wb[..., None])[..., 0] + t_cb


# -- factor residuals over a leading batch, at a perturbation z --


def apply_eps(R, p, v, bg, ba, eps):
    return (R @ lie.so3_exp(eps[..., 0:3]), p + _bmv(R, eps[..., 3:6]),
            v + eps[..., 6:9], bg + eps[..., 9:12], ba + eps[..., 12:15])


def reproj_residual(z, R, p, lm, uvr, cam: Camera, bf, R_cb, t_cb):
    """(B, 3) residuals at z = [pose eps (6), landmark step (3)]; the caller
    zeroes the third row of mono factors. Velocity and biases do not enter,
    so their Jacobian columns are zero."""
    R2 = R @ lie.so3_exp(z[:, 0:3])
    p2 = p + _bmv(R, z[:, 3:6])
    Xb = _bmv(_tr(R2), lm + z[:, 6:9] - p2)
    Xc = _bmv(R_cb, Xb) + t_cb
    uv = project(cam, Xc)
    ur = uv[:, 0] - bf / torch.clamp(Xc[:, 2], min=1e-6)
    return torch.cat([uv - uvr[:, :2], (ur - uvr[:, 2])[:, None]], -1)


def inertial_residual(z, Ri, pi, vi, bgi, bai, Rj, pj, vj, bgj, baj,
                      dT, dR0, dV0, dP0, JRg, JVg, JVa, JPg, JPa, bg0, ba0):
    """(B, 9) preintegration residuals at z = [eps_i (15), eps_j (15)]."""
    R1, p1, v1, bg1, ba1 = apply_eps(Ri, pi, vi, bgi, bai, z[:, :D])
    R2, p2, v2, _, _ = apply_eps(Rj, pj, vj, bgj, baj, z[:, D:])
    g = pre.gravity_vec(R1.device, R1.dtype)
    dt = dT[:, None]
    dbg = bg1 - bg0
    dba = ba1 - ba0
    dR = dR0 @ lie.so3_exp(_bmv(JRg, dbg))
    dV = dV0 + _bmv(JVg, dbg) + _bmv(JVa, dba)
    dP = dP0 + _bmv(JPg, dbg) + _bmv(JPa, dba)
    R1T = _tr(R1)
    er = lie.so3_log(_tr(dR) @ R1T @ R2)
    ev = _bmv(R1T, v2 - v1 - g * dt) - dV
    ep = _bmv(R1T, p2 - p1 - v1 * dt - 0.5 * g * dt * dt) - dP
    return torch.cat([er, ev, ep], -1)


def bias_rw_residual(z, bgi, bai, bgj, baj):
    """(B, 6) random-walk residuals (reference: EdgeGyroRW / EdgeAccRW)."""
    return torch.cat([(bgj + z[:, 24:27]) - (bgi + z[:, 9:12]),
                      (baj + z[:, 27:30]) - (bai + z[:, 12:15])], -1)


def prior_residual(z, R, p, v, bg, ba, pR, pp, pv, pbg, pba):
    """(B, 15) residuals against the prior's linearisation point."""
    R2, p2, v2, bg2, ba2 = apply_eps(R, p, v, bg, ba, z)
    return torch.cat([lie.so3_log(_tr(pR) @ R2), _bmv(_tr(R2), p2 - pp), v2 - pv,
                      bg2 - pbg, ba2 - pba], -1)


def huber_w(chi2, delta2):
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


def sqrt_psd(M):
    """Symmetric square root of PSD (..., n, n) matrices (eigh)."""
    return eig_fn(0.5 * (M + _tr(M)), lambda v: torch.sqrt(torch.clamp(v, min=0.0)))


def outer_w(Ja, Jb, w):
    """sum_r w Ja[r, a] Jb[r, b] per factor: (n, a, b)."""
    return _tr(Ja * w[:, None, None]) @ Jb


def grad_w(J, r, w):
    """-sum_r w J[r, a] r[r] per factor."""
    return -_bmv(_tr(J * w[:, None, None]), r)


# -- residuals and Jacobians at zero perturbation, closed form --


def _eye3(x):
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(x.shape[:-1] + (3, 3))


def reproj_jacobians(R, p, lm, uvr, cam: Camera, bf, R_cb, t_cb):
    """(r (F, 3), J_pose (F, 3, 6), J_lm (F, 3, 3)): with X_b = R^T (lm - p),
    dX_b = [X_b]x dphi - dp + R^T dlm."""
    Rt = _tr(R)
    Xb = _bmv(Rt, lm - p)
    Xc = _bmv(R_cb, Xb) + t_cb
    uv = project(cam, Xc)
    z = Xc[:, 2]
    zc = torch.clamp(z, min=1e-6)
    r = torch.cat([uv - uvr[:, :2], (uv[:, 0] - bf / zc - uvr[:, 2])[:, None]], -1)
    Jp = project_jac(cam, Xc)
    dur_dz = torch.where(z > 1e-6, bf / (zc * zc), torch.zeros_like(z))
    J_ur = Jp[:, 0] + torch.stack([torch.zeros_like(z), torch.zeros_like(z), dur_dz], -1)
    J_xb = torch.cat([Jp, J_ur[:, None]], 1) @ R_cb        # d r / d X_b
    return r, torch.cat([J_xb @ lie.hat(Xb), -J_xb], -1), J_xb @ Rt


def inertial_jacobians(Ri, pi, vi, bgi, bai, Rj, pj, vj, bgj, baj, dT, dR0, dV0, dP0,
                       JRg, JVg, JVa, JPg, JPa, bg0, ba0):
    """(r (P, 9), J (P, 9, 30)) of `inertial_residual` at z = 0."""
    g = pre.gravity_vec(Ri.device, Ri.dtype)
    dt = dT[:, None]
    dbg = bgi - bg0
    dba = bai - ba0
    wg = _bmv(JRg, dbg)
    E = _tr(dR0 @ lie.so3_exp(wg)) @ _tr(Ri) @ Rj
    er = lie.so3_log(E)
    Rit = _tr(Ri)
    xv = _bmv(Rit, vj - vi - g * dt)
    xp = _bmv(Rit, pj - pi - vi * dt - 0.5 * g * dt * dt)
    ev = xv - (dV0 + _bmv(JVg, dbg) + _bmv(JVa, dba))
    ep = xp - (dP0 + _bmv(JPg, dbg) + _bmv(JPa, dba))
    Jinv = lie.so3_right_jacobian_inv(er)
    I3 = _eye3(er)
    O3 = torch.zeros_like(I3)
    RitRj = Rit @ Rj
    J_er = [-Jinv @ _tr(RitRj), O3, O3,
            -Jinv @ _tr(E) @ lie.so3_right_jacobian(wg) @ JRg, O3, Jinv, O3, O3, O3, O3]
    J_ev = [lie.hat(xv), O3, -Rit, -JVg, -JVa, O3, O3, Rit, O3, O3]
    J_ep = [lie.hat(xp), -I3, -Rit * dt[..., None], -JPg, -JPa, O3, RitRj, O3, O3, O3]
    J = torch.cat([torch.cat(J_er, -1), torch.cat(J_ev, -1), torch.cat(J_ep, -1)], -2)
    return torch.cat([er, ev, ep], -1), J


@functools.lru_cache(maxsize=None)
def bias_rw_jacobian(device) -> torch.Tensor:
    """(6, 30) Jacobian of `bias_rw_residual` (constant, read-only)."""
    J = torch.zeros((6, 2 * D), device=device)
    i6 = torch.eye(6, device=device)
    J[:, 9:15] = -i6
    J[:, 24:30] = i6
    return J


def prior_jacobians(R, p, v, bg, ba, pR, pp, pv, pbg, pba):
    """(r (B, 15), J (B, 15, 15)) of `prior_residual` at z = 0."""
    er = lie.so3_log(_tr(pR) @ R)
    xp = _bmv(_tr(R), p - pp)
    I3 = _eye3(er)
    O3 = torch.zeros_like(I3)
    rows = [[lie.so3_right_jacobian_inv(er), O3, O3, O3, O3],
            [lie.hat(xp), I3, O3, O3, O3],
            [O3, O3, I3, O3, O3], [O3, O3, O3, I3, O3], [O3, O3, O3, O3, I3]]
    J = torch.cat([torch.cat(r, -1) for r in rows], -2)
    return torch.cat([er, xp, v - pv, bg - pbg, ba - pba], -1), J


def apply_dx(states: VIStates, dx):
    dx = dx * (~states.fixed)[:, None]
    return states._replace(
        R_wb=lie.so3_normalize(states.R_wb @ lie.so3_exp(dx[:, 0:3])),
        p_wb=states.p_wb + _bmv(states.R_wb, dx[:, 3:6]), v=states.v + dx[:, 6:9],
        bg=states.bg + dx[:, 9:12], ba=states.ba + dx[:, 12:15])


class _Solver:
    """The LM schedule of `solve_vi_ba` over one problem (constant parts
    evaluated once)."""

    def __init__(self, problem: VIProblem, cfg: VIBAConfig):
        self.p = problem
        self.cfg = cfg
        st = problem.states
        rp = problem.reproj
        ine = problem.inertial
        self.W = st.R_wb.shape[0]
        self.L = problem.lm.shape[0]
        self.F = rp.state_idx.shape[0]
        self.P = ine.idx_i.shape[0]
        dev = self.dev = st.R_wb.device
        self.zero = torch.zeros((), device=dev)
        self.is_stereo = rp.uvr[:, 2] >= 0
        self.row_m = torch.stack([torch.ones_like(self.is_stereo),
                                  torch.ones_like(self.is_stereo), self.is_stereo], -1)
        self.chi2_th = torch.where(self.is_stereo, cfg.chi2_stereo, cfg.chi2_mono).to(
            torch.float32)
        self.huber_in = torch.full((), cfg.huber_inertial, device=dev)
        self.sqrt_in = sqrt_psd(ine.info)
        self.sqrt_rw = sqrt_psd(ine.info_rw)
        self.prior_on = bool(problem.prior.valid)
        if self.prior_on:
            self.sqrt_prior = sqrt_psd(problem.prior.H)
        self.w_in = ine.valid & st.valid[ine.idx_i] & st.valid[ine.idx_j]
        self.ifree = (~st.fixed[ine.idx_i])[:, None, None]
        self.jfree = (~st.fixed[ine.idx_j])[:, None, None]
        self.lm_act = problem.lm_valid & ~problem.lm_fixed
        si, li, W, L = rp.state_idx, rp.lm_idx, self.W, self.L
        self.pair = si * W + si
        self.wl = si * L + li
        i, j = ine.idx_i, ine.idx_j
        self.blocks = (i * W + i, j * W + j, i * W + j, j * W + i)

    def _masked(self, x):
        """Zero the right-image row of mono factors ((F, 3) or (F, 3, n))."""
        m = self.row_m if x.ndim == 2 else self.row_m[..., None]
        return torch.where(m, x, self.zero)

    def _reproj_args(self, states, lm):
        p = self.p
        si, li = p.reproj.state_idx, p.reproj.lm_idx
        return (states.R_wb[si], states.p_wb[si], lm[li], p.reproj.uvr, p.cam,
                p.bf, p.R_cb, p.t_cb)

    def _inertial_args(self, states):
        ine = self.p.inertial
        i, j = ine.idx_i, ine.idx_j
        return (states.R_wb[i], states.p_wb[i], states.v[i], states.bg[i], states.ba[i],
                states.R_wb[j], states.p_wb[j], states.v[j], states.bg[j], states.ba[j],
                ine.dT, ine.dR, ine.dV, ine.dP, ine.JRg, ine.JVg, ine.JVa, ine.JPg,
                ine.JPa, ine.bg0, ine.ba0)

    def _rw_args(self, states):
        i, j = self.p.inertial.idx_i, self.p.inertial.idx_j
        return states.bg[i], states.ba[i], states.bg[j], states.ba[j]

    def _prior_args(self, states):
        q = self.p.prior
        k = q.state_idx
        return (states.R_wb[k:k + 1], states.p_wb[k:k + 1], states.v[k:k + 1],
                states.bg[k:k + 1], states.ba[k:k + 1], q.R_wb, q.p_wb, q.v, q.bg, q.ba)

    def reproj_chi2(self, states, lm):
        z = torch.zeros((self.F, 9), device=self.dev)
        r = self._masked(reproj_residual(z, *self._reproj_args(states, lm)))
        return (r * r).sum(-1) * self.p.reproj.inv_sigma2

    def linearize(self, states, lm, inlier):
        """(H (W, 15, W, 15), b (W, 15), Hll (L, 3, 3), bl (L, 3), Hpl_f
        (F, 15, 3))."""
        p, W, L, dev = self.p, self.W, self.L, self.dev
        st = p.states
        rp = p.reproj
        si, li = rp.state_idx, rp.lm_idx
        r_f, Jp, Jl_f = reproj_jacobians(*self._reproj_args(states, lm))
        r_f = self._masked(r_f)
        Js_f = torch.cat([self._masked(Jp), torch.zeros((self.F, 3, 9), device=dev)], -1)
        Jl_f = self._masked(Jl_f)
        chi2_f = (r_f * r_f).sum(-1) * rp.inv_sigma2
        w_f = (rp.inv_sigma2 * huber_w(chi2_f, self.chi2_th) * rp.valid * inlier
               * st.valid[si] * p.lm_valid[li])
        Js_f = Js_f * (~st.fixed[si])[:, None, None]
        Jl_f = Jl_f * (~p.lm_fixed[li])[:, None, None]

        H = index_add_rows(torch.zeros((W * W, D, D), device=dev), self.pair,
                           outer_w(Js_f, Js_f, w_f))
        b = index_add_rows(torch.zeros((W, D), device=dev), si, grad_w(Js_f, r_f, w_f))
        Hll = index_add_rows(torch.zeros((L, 3, 3), device=dev), li,
                             outer_w(Jl_f, Jl_f, w_f))
        bl = index_add_rows(torch.zeros((L, 3), device=dev), li, grad_w(Jl_f, r_f, w_f))

        r_p, J = inertial_jacobians(*self._inertial_args(states))
        r_pw = _bmv(self.sqrt_in, r_p)
        Ji_pw = self.sqrt_in @ J[..., :D] * self.ifree
        Jj_pw = self.sqrt_in @ J[..., D:] * self.jfree
        w_p = huber_w((r_pw * r_pw).sum(-1), self.huber_in) * self.w_in
        self._add_pair(H, b, Ji_pw, Jj_pw, r_pw, w_p)

        z30 = torch.zeros((self.P, 2 * D), device=dev)
        r_b = bias_rw_residual(z30, *self._rw_args(states))
        J = bias_rw_jacobian(dev)
        r_bw = _bmv(self.sqrt_rw, r_b)
        Ji_bw = self.sqrt_rw @ J[..., :D] * self.ifree
        Jj_bw = self.sqrt_rw @ J[..., D:] * self.jfree
        self._add_pair(H, b, Ji_bw, Jj_bw, r_bw, self.w_in.to(torch.float32))

        if self.prior_on:
            k = p.prior.state_idx
            r_q, Jq = prior_jacobians(*self._prior_args(states))
            r_qw = self.sqrt_prior @ r_q[0]
            Jq_w = self.sqrt_prior @ Jq[0]
            w_q = (~st.fixed[k]).to(torch.float32)
            H[k * W + k] += w_q * Jq_w.T @ Jq_w
            b[k] -= w_q * Jq_w.T @ r_qw
        Hpl_f = outer_w(Js_f, Jl_f, w_f)
        H = H.reshape(W, W, D, D).permute(0, 2, 1, 3)
        return H, b, Hll, bl, Hpl_f

    def _add_pair(self, H, b, Ji, Jj, r, w):
        ine = self.p.inertial
        ii, jj, ij, ji = self.blocks
        Hx = outer_w(Ji, Jj, w)
        H.index_add_(0, ii, outer_w(Ji, Ji, w))
        H.index_add_(0, jj, outer_w(Jj, Jj, w))
        H.index_add_(0, ij, Hx)
        H.index_add_(0, ji, _tr(Hx))
        b.index_add_(0, ine.idx_i, grad_w(Ji, r, w))
        b.index_add_(0, ine.idx_j, grad_w(Jj, r, w))

    def total_chi2(self, states, lm, inlier):
        """Robustified reprojection + inertial + bias random walk + prior."""
        p, zero = self.p, self.zero
        c = torch.where(p.reproj.valid & inlier,
                        torch.minimum(self.reproj_chi2(states, lm), self.chi2_th * 4),
                        zero).sum()
        z30 = torch.zeros((self.P, 2 * D), device=self.dev)
        r_pw = _bmv(self.sqrt_in, inertial_residual(z30, *self._inertial_args(states)))
        c = c + torch.where(self.w_in, (r_pw * r_pw).sum(-1), zero).sum()
        r_bw = _bmv(self.sqrt_rw, bias_rw_residual(z30, *self._rw_args(states)))
        c = c + torch.where(self.w_in, (r_bw * r_bw).sum(-1), zero).sum()
        if self.prior_on:
            r_q = prior_residual(torch.zeros((1, D), device=self.dev),
                                 *self._prior_args(states))[0]
            c = c + r_q @ p.prior.H @ r_q
        return c

    def iteration(self, states, lm, inlier, lam):
        p, W, L, dev = self.p, self.W, self.L, self.dev
        st = p.states
        H, b, Hll, bl, Hpl_f = self.linearize(states, lm, inlier)
        # Schur complement of the landmarks over (state, landmark) buckets
        eye3 = torch.eye(3, device=dev)
        act = self.lm_act
        Hll_inv = inv3(Hll + eye3 * 1e-6 + (~act)[:, None, None] * eye3) * act[:, None, None]
        A = index_add_rows(torch.zeros((W * L, D, 3), device=dev), self.wl, Hpl_f)
        A = A.reshape(W, L, D, 3)
        B = torch.einsum("wlab,lbc->wlac", A, Hll_inv)
        Hd = (H - torch.einsum("wlac,vlec->wave", B, A)).reshape(W * D, W * D)
        b_red = b - torch.einsum("wlab,lb->wa", B, bl)
        free = (~st.fixed & st.valid).repeat_interleave(D)
        damp = torch.where(free, lam * torch.clamp(torch.diagonal(Hd), min=1e-3),
                           torch.ones((), device=dev))
        Lc, _ = torch.linalg.cholesky_ex(Hd + torch.diag(damp))
        dx = torch.cholesky_solve(b_red.reshape(-1, 1), Lc).reshape(W, D)
        dx = dx * (st.valid & ~st.fixed)[:, None]
        dlm = _bmv(Hll_inv, bl - torch.einsum("wlab,wa->lb", A, dx)) * act[:, None]
        states2 = apply_dx(states, dx)
        lm2 = lm + dlm
        ok = self.total_chi2(states2, lm2, inlier) < self.total_chi2(states, lm, inlier)
        states = states._replace(**{f: torch.where(ok, getattr(states2, f),
                                                   getattr(states, f))
                                    for f in ("R_wb", "p_wb", "v", "bg", "ba")})
        lm = torch.where(ok, lm2, lm)
        lam = torch.where(ok, torch.clamp(lam * 0.3, min=1e-8),
                          torch.clamp(lam * 10.0, max=1e6))
        return states, lm, lam


def solve_vi_ba(problem: VIProblem, cfg: VIBAConfig = VIBAConfig(),
                want_info: bool = True):
    """LM schedule with per-round chi2 outlier gating. Returns (problem with
    updated states / landmarks, reprojection inlier mask, H_full (15W, 15W)
    the Gauss-Newton information of the final linearisation, or None when
    `want_info` is False: the reference's callers that drop it get it
    removed by XLA)."""
    s = _Solver(problem, cfg)
    states, lm = problem.states, problem.lm
    inlier = torch.ones(s.F, dtype=torch.bool, device=s.dev)
    for _ in range(cfg.n_rounds):
        lam = torch.full((), cfg.lambda0, device=s.dev)
        for _ in range(cfg.n_iters):
            states, lm, lam = s.iteration(states, lm, inlier, lam)
        inlier = s.reproj_chi2(states, lm) <= s.chi2_th
    H_fin = None
    if want_info:
        H_fin = s.linearize(states, lm, inlier)[0].reshape(s.W * D, s.W * D)
    return problem._replace(states=states, lm=lm), inlier, H_fin


def marginalize(H: torch.Tensor, keep: slice, marg: slice) -> torch.Tensor:
    """Schur-complement marginalisation with an eigen pseudo-inverse
    (reference: Optimizer::Marginalize). Returns the kept block's marginal
    information."""
    Hkm = H[keep, marg]
    Hmm = H[marg, marg]
    Hmm_inv = eig_fn(0.5 * (Hmm + Hmm.T), lambda v: torch.where(
        v > 1e-8, 1.0 / torch.clamp(v, min=1e-8), torch.zeros_like(v)))
    return H[keep, keep] - Hkm @ Hmm_inv @ Hkm.T
