"""Pose-graph (essential-graph) optimisation over Sim3 / SE3 / 4-DoF states
(port of orb_slam3_vio_fixes_tpu/optim/pose_graph.py).

All edges live in one fixed-capacity batch; residuals r_ij = log(S_ji S_i
S_j^-1) and their 7x7 Jacobians (forward-mode autodiff of the left
perturbation at zero) are evaluated for every edge at once, the normal
equations are accumulated block-wise into a dense (K*7, K*7) matrix and
solved with one Cholesky factorisation per Levenberg-Marquardt step.
Tangent layout (rho, phi, sigma); `fix_scale` freezes sigma, `four_dof`
keeps translation and yaw only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam3_vio_fixes_tpu_torch.utils import lie
from orb_slam3_vio_fixes_tpu_torch.utils.autodiff import jac_rows


class PoseGraphEdges(NamedTuple):
    """Relative-pose constraints; measurement S_ji = S_j S_i^-1."""

    idx_i: torch.Tensor   # (E,) int64
    idx_j: torch.Tensor   # (E,) int64
    R_ji: torch.Tensor    # (E, 3, 3)
    t_ji: torch.Tensor    # (E, 3)
    s_ji: torch.Tensor    # (E,)
    weight: torch.Tensor  # (E,)
    valid: torch.Tensor   # (E,) bool

    @staticmethod
    def empty(e: int, device) -> "PoseGraphEdges":
        return PoseGraphEdges(
            idx_i=torch.zeros(e, dtype=torch.int64, device=device),
            idx_j=torch.zeros(e, dtype=torch.int64, device=device),
            R_ji=torch.eye(3, device=device).repeat(e, 1, 1),
            t_ji=torch.zeros((e, 3), device=device),
            s_ji=torch.ones(e, device=device),
            weight=torch.ones(e, device=device),
            valid=torch.zeros(e, dtype=torch.bool, device=device))


def relative_sim3(R_i, t_i, s_i, R_j, t_j, s_j):
    """S_i S_j^-1."""
    return lie.sim3_compose(R_i, t_i, s_i, *lie.sim3_inverse(R_j, t_j, s_j))


def _edge_residual(R_i, t_i, s_i, R_j, t_j, s_j, R_m, t_m, s_m):
    """log(S_m S_i S_j^-1) in R^7."""
    R_e, t_e, s_e = relative_sim3(R_i, t_i, s_i, R_j, t_j, s_j)
    return lie.sim3_log(*lie.sim3_compose(R_m, t_m, s_m, R_e, t_e, s_e))


def _res_and_jac(R_i, t_i, s_i, R_j, t_j, s_j, R_m, t_m, s_m):
    """Residuals (E, 7) and their Jacobians (E, 7, 7) each with respect to
    a left perturbation of the i and j endpoints."""
    def f(xi, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
        Ri2, ti2, si2 = lie.sim3_compose(*lie.sim3_exp(xi[:, :7]), Ri, ti, si)
        Rj2, tj2, sj2 = lie.sim3_compose(*lie.sim3_exp(xi[:, 7:]), Rj, tj, sj)
        return _edge_residual(Ri2, ti2, si2, Rj2, tj2, sj2, Rm, tm, sm)

    z = torch.zeros((R_i.shape[0], 14), device=R_i.device)
    res, J = jac_rows(f, z, R_i, t_i, s_i, R_j, t_j, s_j, R_m, t_m, s_m)
    return res, J[..., :7], J[..., 7:]


class PoseGraphConfig(NamedTuple):
    n_iters: int = 10
    fix_scale: bool = False
    four_dof: bool = False
    lambda0: float = 1e-4


def optimize_pose_graph(R, t, s, fixed, edges: PoseGraphEdges,
                        cfg: PoseGraphConfig = PoseGraphConfig()):
    """Levenberg-Marquardt over the whole graph: R (K, 3, 3) T_cw rotations,
    t (K, 3), s (K,), fixed (K,) bool gauge anchors. Returns (R, t, s,
    chi2 (n_iters,)) with chi2 each step's cost before the step."""
    K = R.shape[0]
    D = 7
    dev = R.device
    dof = torch.ones(D, device=dev)
    if cfg.fix_scale:
        dof[6] = 0.0
    if cfg.four_dof:
        dof[3] = dof[4] = dof[6] = 0.0
    w = torch.where(edges.valid, edges.weight, torch.zeros((), device=dev))
    sw = w.sqrt()
    ii, jj = edges.idx_i, edges.idx_j

    def ends(R, t, s):
        return (R[ii], t[ii], s[ii], R[jj], t[jj], s[jj],
                edges.R_ji, edges.t_ji, edges.s_ji)

    def chi2_of(R, t, s):
        res = _edge_residual(*ends(R, t, s))
        return (w * (res * res).sum(-1)).sum()

    free = ~fixed
    diag_mask = (dof > 0).repeat(K) & free.repeat_interleave(D)
    lam = torch.full((), cfg.lambda0, device=dev)
    chis = []
    for _ in range(cfg.n_iters):
        res, J_i, J_j = _res_and_jac(*ends(R, t, s))
        J_i = J_i * (sw * free[ii])[:, None, None] * dof
        J_j = J_j * (sw * free[jj])[:, None, None] * dof
        r_w = res * sw[:, None]
        chi2_cur = (r_w * r_w).sum()
        # blocks (i, j) of the normal equations, accumulated at i * K + j
        blocks = torch.zeros((K * K, D, D), device=dev)
        blocks.index_add_(0, ii * K + ii, J_i.transpose(1, 2) @ J_i)
        blocks.index_add_(0, jj * K + jj, J_j.transpose(1, 2) @ J_j)
        Hij = J_i.transpose(1, 2) @ J_j
        blocks.index_add_(0, ii * K + jj, Hij)
        blocks.index_add_(0, jj * K + ii, Hij.transpose(1, 2))
        b = torch.zeros((K, D), device=dev)
        b.index_add_(0, ii, -(J_i.transpose(1, 2) @ r_w[..., None])[..., 0])
        b.index_add_(0, jj, -(J_j.transpose(1, 2) @ r_w[..., None])[..., 0])
        Hd = blocks.reshape(K, K, D, D).permute(0, 2, 1, 3).reshape(K * D, K * D)
        hdiag = torch.diagonal(Hd)
        damp = torch.where(diag_mask, lam * torch.clamp(hdiag, min=1e-3),
                           torch.ones_like(hdiag))
        L, _ = torch.linalg.cholesky_ex(Hd + torch.diag(damp))
        dx = torch.cholesky_solve(b.reshape(-1, 1), L).reshape(K, D)
        dx = dx * dof * free[:, None]
        R2, t2, s2 = lie.sim3_compose(*lie.sim3_exp(dx), R, t, s)
        R2 = lie.so3_normalize(R2)
        ok = chi2_of(R2, t2, s2) < chi2_cur
        R = torch.where(ok, R2, R)
        t = torch.where(ok, t2, t)
        s = torch.where(ok, s2, s)
        lam = torch.where(ok, torch.clamp(lam * 0.3, min=1e-8),
                          torch.clamp(lam * 8.0, max=1e6))
        chis.append(chi2_cur)
    return R, t, s, torch.stack(chis)


def essential_edges_from_map(kf_R, kf_t, kf_valid, kf_prev, cov, max_edges: int,
                             cov_threshold: int = 100, *, device):
    """Edges from a host (numpy) map snapshot: the temporal kf_prev chain and
    the covisibility pairs with >= cov_threshold shared points, measured at
    the current relative poses."""
    K = kf_R.shape[0]
    kf_valid = np.asarray(kf_valid)
    kf_prev = np.asarray(kf_prev)
    ii, jj = [], []
    for k in range(K):
        p = int(kf_prev[k])
        if kf_valid[k] and p >= 0 and kf_valid[p]:
            ii.append(k)
            jj.append(p)
    cov = np.asarray(cov)
    a_idx, b_idx = np.nonzero(np.triu(cov >= cov_threshold, 1)
                              & kf_valid[:, None] & kf_valid[None, :])
    ii += a_idx.tolist()
    jj += b_idx.tolist()
    n = min(len(ii), max_edges)
    edges = PoseGraphEdges.empty(max_edges, device)
    if n == 0:
        return edges
    ii = torch.as_tensor(np.asarray(ii[:n], np.int64), device=device)
    jj = torch.as_tensor(np.asarray(jj[:n], np.int64), device=device)
    kR = torch.as_tensor(np.asarray(kf_R, np.float32), device=device)
    kt = torch.as_tensor(np.asarray(kf_t, np.float32), device=device)
    ones = torch.ones(n, device=device)
    R_m, t_m, s_m = relative_sim3(kR[jj], kt[jj], ones, kR[ii], kt[ii], ones)
    edges.idx_i[:n] = ii
    edges.idx_j[:n] = jj
    edges.R_ji[:n] = R_m
    edges.t_ji[:n] = t_m
    edges.s_ji[:n] = s_m
    edges.valid[:n] = True
    return edges


def add_loop_edge(edges: PoseGraphEdges, slot: int, i: int, j: int, R_ji, t_ji,
                  s_ji, weight: float = 100.0) -> PoseGraphEdges:
    """Write one loop constraint into slot `slot` (in place)."""
    edges.idx_i[slot] = i
    edges.idx_j[slot] = j
    edges.R_ji[slot] = R_ji
    edges.t_ji[slot] = t_ji
    edges.s_ji[slot] = s_ji
    edges.weight[slot] = weight
    edges.valid[slot] = True
    return edges
