"""Closed-form Sim3/SE3 alignment (Horn) and batched-hypothesis RANSAC (port
of orb_slam3_vio_fixes_tpu/ops/sim3.py).

Every hypothesis is a minimal 3-point set; all Horn problems are solved as
one batch and scored against all correspondences in one (H, N) pass, and the
winner is refined once on its inliers. The RANSAC is split in two: `sample`
draws the (H, 3) index sets from an explicit `torch.Generator` (the
reference draws them with `jax.random.categorical`), and `sim3_from_samples`
scores given index sets, so both packages can be fed the same samples.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam3_vio_fixes_tpu_torch.utils import lie
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera, project, project_jac
from orb_slam3_vio_fixes_tpu_torch.utils.linalg import take


def horn_alignment(src, dst, weight, fix_scale: bool = False):
    """Weighted closed-form similarity with dst ~ s R src + t.
    src, dst (..., N, 3); weight (..., N) >= 0. Returns (R, t, s)."""
    wn = weight / torch.clamp(weight.sum(-1, keepdim=True), min=1e-9)
    mu_s = (wn[..., None] * src).sum(-2)
    mu_d = (wn[..., None] * dst).sum(-2)
    cs = src - mu_s[..., None, :]
    cd = dst - mu_d[..., None, :]
    W = (wn[..., None] * cd).transpose(-1, -2) @ cs          # dst x src
    U, S, Vt = torch.linalg.svd(W)
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    R = U @ (D[..., :, None] * Vt)
    if fix_scale:
        s = torch.ones_like(det)
    else:
        var_s = (wn * (cs * cs).sum(-1)).sum(-1)
        s = (S * D).sum(-1) / torch.clamp(var_s, min=1e-12)
    t = mu_d - s[..., None] * (R @ mu_s[..., None])[..., 0]
    return R, t, s


class Sim3Result(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    inliers: torch.Tensor   # (N,) bool
    n_inliers: torch.Tensor


def yaw_only(R_m, t_m, R_cur, t_cur, R_cand, t_cand):
    """Clamp a measured relative pose between two gravity-aligned frames to
    yaw: the discrepancy between (R_m, t_m), which maps candidate-camera
    coordinates into current-camera coordinates, and the relative pose of
    the two keyframes' poses (R_cur, t_cur), (R_cand, t_cand), is taken into
    the world frame, its roll and pitch are zeroed (the IMU fixes them),
    and the pose is composed again; the translation in the candidate's
    camera frame is kept. Host float64 arrays in and out: (R, t)."""
    f64 = np.float64
    R_m, t_m, R_cur, t_cur, R_cand, t_cand = (
        np.asarray(x, f64) for x in (R_m, t_m, R_cur, t_cur, R_cand, t_cand))
    R_o = R_cur @ R_cand.T
    t_o = t_cur - R_o @ t_cand
    R_e = R_o.T @ R_m
    t_e = R_o.T @ (t_m - t_o)
    R_ew = R_cand.T @ R_e @ R_cand
    w = lie.so3_log(torch.as_tensor(R_ew, dtype=torch.float32)).numpy().astype(f64)
    w[:2] = 0.0
    R_ew = lie.so3_exp(torch.as_tensor(w, dtype=torch.float32)).numpy().astype(f64)
    return R_o @ (R_cand @ R_ew @ R_cand.T), R_o @ t_e + t_o


def sample(gen: torch.Generator, valid: torch.Tensor, n_hyp: int,
           k: int) -> torch.Tensor:
    """(n_hyp, k) indices drawn uniformly, with replacement, among the valid
    slots (among all slots when none is valid, as a categorical over equal
    logits does)."""
    w = valid.to(torch.float32)
    w = torch.where(valid.any(), w, torch.ones_like(w))
    return torch.multinomial(w, n_hyp * k, replacement=True,
                             generator=gen).reshape(n_hyp, k)


def _two_way_errors(R, t, s, pts1, pts2, obs1, obs2, cam1, cam2, sigma2_1,
                    sigma2_2):
    """Per-correspondence reprojection chi2 in both cameras and depths of
    (R, t, s) mapping pts2 into the pts1 frame (batched over leading dims)."""
    p2in1 = s[..., None, None] * (pts2 @ R.transpose(-1, -2)) + t[..., None, :]
    e1 = ((project(cam1, p2in1) - obs1) ** 2).sum(-1) / sigma2_1
    p1in2 = (1.0 / s)[..., None, None] * ((pts1 - t[..., None, :]) @ R)
    e2 = ((project(cam2, p1in2) - obs2) ** 2).sum(-1) / sigma2_2
    return e1, e2, p2in1[..., 2], p1in2[..., 2]


def sim3_from_samples(idx, pts1, pts2, valid, cam1: Camera, cam2: Camera,
                      sigma2_1, sigma2_2, fix_scale: bool = False,
                      chi2_th: float = 9.21) -> Sim3Result:
    """Score the (H, 3) hypotheses `idx`, keep the one with most inliers
    (first on ties), refit it on its inliers with one weighted Horn pass and
    re-gate. The Sim3 maps pts2's frame into pts1's."""
    n_hyp = idx.shape[0]
    R, t, s = horn_alignment(pts2[idx], pts1[idx],
                             torch.ones((n_hyp, 3), device=pts1.device), fix_scale)
    obs1 = project(cam1, pts1)
    obs2 = project(cam2, pts2)
    e1, e2, z1, z2 = _two_way_errors(R, t, s, pts1[None], pts2[None], obs1, obs2,
                                     cam1, cam2, sigma2_1, sigma2_2)
    good = (e1 < chi2_th) & (e2 < chi2_th) & valid[None] & (z1 > 0) & (z2 > 0)
    best = torch.argmax(good.sum(-1))
    inl = take(good, best)
    Rr, tr, sr = horn_alignment(pts2, pts1, inl.to(torch.float32), fix_scale)
    e1r, e2r, z1r, z2r = _two_way_errors(Rr, tr, sr, pts1, pts2, obs1, obs2,
                                         cam1, cam2, sigma2_1, sigma2_2)
    inl_r = (e1r < chi2_th) & (e2r < chi2_th) & valid & (z1r > 0) & (z2r > 0)
    return Sim3Result(Rr, tr, sr, inl_r, inl_r.sum())


def sim3_ransac(gen: torch.Generator, pts1, pts2, valid, cam1: Camera,
                cam2: Camera, sigma2_1, sigma2_2, n_hyp: int = 128,
                fix_scale: bool = False, chi2_th: float = 9.21) -> Sim3Result:
    """Batched RANSAC Sim3 between matched camera-frame point sets."""
    idx = sample(gen, valid, n_hyp, 3)
    return sim3_from_samples(idx, pts1, pts2, valid, cam1, cam2, sigma2_1,
                             sigma2_2, fix_scale, chi2_th)


def sim3_refine(R, t, s, pts1, pts2, valid, cam1: Camera, cam2: Camera,
                sigma2_1, sigma2_2, n_iters: int = 8, fix_scale: bool = False,
                chi2_th: float = 9.21, huber2: float = 10.0) -> Sim3Result:
    """Gauss-Newton over the symmetric reprojection errors with Huber IRLS
    weights (OptimizeSim3). The 7-DoF update d = (w, v, sigma) is the left
    perturbation x -> e^sigma Exp(w) (s R x + t) + v; the reference takes
    its Jacobian by forward-mode autodiff at d = 0, the port in closed form:
    for p = s R x2 + t, dp/dd = [-[p]x | I | p], and for
    q = (1/s) R^T (x1 - t), dq/dd = (1/s) R^T [[x1]x | -I | -x1]; the sigma
    column is zero with a fixed scale."""
    obs1 = project(cam1, pts1)
    obs2 = project(cam2, pts2)
    inv_sig1 = 1.0 / torch.sqrt(torch.clamp(sigma2_1, min=1e-9))
    inv_sig2 = 1.0 / torch.sqrt(torch.clamp(sigma2_2, min=1e-9))
    dev = pts1.device
    n = pts1.shape[0]
    eye3 = torch.eye(3, device=dev).expand(n, 3, 3)
    sig_on = 0.0 if fix_scale else 1.0

    def residuals(R_, t_, s_):
        p = s_ * (pts2 @ R_.T) + t_
        q = (1.0 / s_) * ((pts1 - t_) @ R_)
        r1 = (project(cam1, p) - obs1) * inv_sig1[:, None]
        r2 = (project(cam2, q) - obs2) * inv_sig2[:, None]
        return p, q, r1, r2, (p[:, 2] > 1e-3) & (q[:, 2] > 1e-3)

    s = torch.as_tensor(s, dtype=torch.float32, device=dev)
    zero = torch.zeros((), device=dev)
    for _ in range(n_iters):
        p, q, r1, r2, depth_ok = residuals(R, t, s)
        act = valid & depth_ok
        w1 = torch.where(act, torch.clamp(torch.sqrt(
            huber2 / torch.clamp((r1 * r1).sum(-1), min=1e-12)), max=1.0), zero)
        w2 = torch.where(act, torch.clamp(torch.sqrt(
            huber2 / torch.clamp((r2 * r2).sum(-1), min=1e-12)), max=1.0), zero)
        dp = torch.cat([-lie.hat(p), eye3, sig_on * p[..., None]], -1)         # (N, 3, 7)
        dq = (R.T / s) @ torch.cat([lie.hat(pts1), -eye3, -sig_on * pts1[..., None]], -1)
        J1 = (project_jac(cam1, p) @ dp) * inv_sig1[:, None, None]             # (N, 2, 7)
        J2 = (project_jac(cam2, q) @ dq) * inv_sig2[:, None, None]
        J = torch.cat([J1.reshape(-1, 7), J2.reshape(-1, 7)])
        r = torch.cat([r1.reshape(-1), r2.reshape(-1)])
        w = torch.cat([w1.repeat_interleave(2), w2.repeat_interleave(2)])
        JtW = J.T * w[None, :]
        H = JtW @ J + 1e-6 * torch.eye(7, device=dev)
        d = -torch.linalg.solve_ex(H, JtW @ r)[0]
        dR = lie.so3_exp(d[:3])
        ds = torch.exp(d[6]) if not fix_scale else torch.ones((), device=dev)
        R, t, s = dR @ R, ds * (dR @ t) + d[3:6], ds * s
    _, _, r1, r2, depth_ok = residuals(R, t, s)
    inl = ((r1 * r1).sum(-1) < chi2_th) & ((r2 * r2).sum(-1) < chi2_th) & valid & depth_ok
    return Sim3Result(R, t, s, inl, inl.sum())
