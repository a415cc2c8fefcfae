"""Lie groups SO(3)/SE(3)/Sim(3) (port of orb_slam3_vio_fixes_tpu/utils/lie.py).

Rotations are 3x3 matrices; every function broadcasts over leading batch
dims; small-angle branches use `torch.where`, so nothing syncs with the host.
"""

from __future__ import annotations

import math

import torch

from orb_slam3_vio_fixes_tpu_torch.utils.linalg import adjugate3

_EPS = 1e-8


def _eye_like(x: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(shape)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _taylor_coeffs(theta_sq: torch.Tensor):
    """(sin t/t, (1-cos t)/t^2, (t-sin t)/t^3), Taylor-safe."""
    small = theta_sq < _EPS
    theta = torch.sqrt(theta_sq + _EPS * small.to(theta_sq.dtype))
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / theta_sq)
    c = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (theta_sq * theta))
    return a, b, c


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    theta_sq = (w * w).sum(-1)
    a, b, _ = _taylor_coeffs(theta_sq)
    W = hat(w)
    return (_eye_like(w, W.shape) + a[..., None, None] * W
            + b[..., None, None] * (W @ W))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map, robust near 0 and near pi (see the reference's comments)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)
    sin_theta = torch.sin(theta)
    generic_scale = torch.where(
        theta < 1e-5, 0.5 + theta * theta / 12.0,
        theta / (2.0 * torch.clamp(sin_theta, min=1e-20)))
    Rt = R.transpose(-1, -2)
    w_generic = generic_scale[..., None] * vee(R - Rt)
    S = 0.5 * (R + Rt)
    diag = torch.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    M = 0.5 * (S + torch.eye(3, dtype=S.dtype, device=S.device))
    col = torch.take_along_dim(M, k[..., None, None].expand(M.shape[:-1] + (1,)),
                               dim=-1)[..., 0]
    kk = torch.take_along_dim(col, k[..., None], dim=-1)[..., 0]
    axis = col / torch.sqrt(torch.clamp(kk, min=1e-12))[..., None]
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True),
                              min=1e-12)
    w_small = vee(R - Rt)
    sign = torch.where((w_small * axis).sum(-1, keepdim=True) < 0.0, -1.0, 1.0)
    sin_t = 0.5 * torch.sqrt((w_small * w_small).sum(-1) + 1e-24)
    theta_pi = math.pi - torch.arcsin(torch.clamp(sin_t, 0.0, 1.0 - 1e-7))
    w_pi = theta_pi[..., None] * axis * sign
    near_pi = (math.pi - theta) < 5e-4
    return torch.where(near_pi[..., None], w_pi, w_generic)


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    theta_sq = (w * w).sum(-1)
    _, b, c = _taylor_coeffs(theta_sq)
    W = hat(w)
    return (_eye_like(w, W.shape) + b[..., None, None] * W
            + c[..., None, None] * (W @ W))


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    return so3_left_jacobian(-w)


def so3_right_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta_sq = (w * w).sum(-1)
    small = theta_sq < _EPS
    theta = torch.sqrt(theta_sq + _EPS * small.to(theta_sq.dtype))
    W = hat(w)
    coef = torch.where(
        small, 1.0 / 12.0 + theta_sq / 720.0,
        (1.0 / theta_sq)
        - (1.0 + torch.cos(theta)) / (2.0 * theta * torch.sin(theta) + 1e-20))
    return _eye_like(w, W.shape) + 0.5 * W + coef[..., None, None] * (W @ W)


def so3_normalize(R: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Nearest rotation to R (its orthogonal polar factor U V^T).

    The reference takes it from an SVD; here Newton's polar iteration
    X <- (X + X^-T) / 2 with the closed-form 3x3 inverse gives the same
    factor without a batched-SVD solver call (a library call with its own
    workspace per use, on the per-frame path). It converges quadratically
    from the near-rotations every caller passes (fp32 precision in ~3 steps
    from singular values within 2x of 1); like the reference's det fix it
    returns a proper rotation for det(R) > 0, which all callers guarantee.
    Three steps take a drift of 1e-3 below float32 resolution."""
    X = R
    for _ in range(iters):
        adj, det = adjugate3(X)           # X^-T = adj(X)^T / det(X)
        X = 0.5 * (X + adj.transpose(-1, -2) / det[..., None, None])
    return X


# --- SE(3) as (R, t) pairs -------------------------------------------------


def se3_exp(xi: torch.Tensor):
    """xi = (..., 6) ordered (rho, phi). Returns (R, t = J_l(phi) rho)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = (so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    return R, t


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    phi = so3_log(R)
    theta_sq = (phi * phi).sum(-1)
    W = hat(phi)
    small = theta_sq < _EPS
    theta = torch.sqrt(theta_sq + _EPS * small.to(theta_sq.dtype))
    coef = torch.where(
        small, 1.0 / 12.0 + theta_sq / 720.0,
        (1.0 / theta_sq) * (1.0 - (theta * torch.sin(theta))
                            / (2.0 * (1.0 - torch.cos(theta)) + 1e-20)))
    Jl_inv = _eye_like(R, W.shape) - 0.5 * W + coef[..., None, None] * (W @ W)
    rho = (Jl_inv @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_compose(Ra, ta, Rb, tb):
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def se3_apply(R, t, p):
    return (R @ p[..., None])[..., 0] + t


# --- Sim(3) as (R, t, s) ---------------------------------------------------


def sim3_apply(R, t, s, p):
    return s[..., None] * (R @ p[..., None])[..., 0] + t


def sim3_inverse(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * (Rt @ t[..., None])[..., 0], s_inv


def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    return Ra @ Rb, sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta, sa * sb


def sim3_exp(xi: torch.Tensor):
    """xi = (..., 7) ordered (rho, phi, sigma); closed-form W matrix."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    R = so3_exp(phi)
    theta_sq = (phi * phi).sum(-1)
    near_zero_theta = theta_sq < _EPS
    theta = torch.sqrt(theta_sq + _EPS * near_zero_theta.to(theta_sq.dtype))
    W = hat(phi)
    W2 = W @ W
    near_zero_sigma = sigma.abs() < 1e-5
    sig = torch.where(near_zero_sigma, torch.ones_like(sigma), sigma)
    th = torch.where(near_zero_theta, torch.ones_like(theta), theta)
    a_coef = torch.where(near_zero_sigma, 1.0 + sigma / 2.0, (s - 1.0) / sig)
    denom = sig * sig + th * th
    b_gen = (sig * (s * torch.sin(th)) + (1.0 - s * torch.cos(th)) * th) / (
        th * denom)
    c_gen = ((s - 1.0) / sig / (th * th)
             - ((s * torch.cos(th) - 1.0) * sig + s * torch.sin(th) * th)
             / (th * th * denom))
    _, b_rot, c_rot = _taylor_coeffs(theta_sq)
    b_coef = torch.where(near_zero_sigma, b_rot,
                         torch.where(near_zero_theta, 0.5, b_gen))
    c_coef = torch.where(near_zero_sigma, c_rot,
                         torch.where(near_zero_theta, 1.0 / 6.0, c_gen))
    Wmat = (a_coef[..., None, None] * _eye_like(xi, W.shape)
            + b_coef[..., None, None] * W + c_coef[..., None, None] * W2)
    return R, (Wmat @ rho[..., None])[..., 0], s


def sim3_log(R, t, s):
    phi = so3_log(R)
    sigma = torch.log(s)
    eye3 = torch.eye(3, dtype=R.dtype, device=R.device)
    cols = []
    for i in range(3):
        xi = torch.cat([eye3[i].expand(phi.shape), phi, sigma[..., None]], -1)
        cols.append(sim3_exp(xi)[1])
    Wmat = torch.stack(cols, dim=-1)
    rho = torch.linalg.solve(Wmat, t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


# --- quaternions (x, y, z, w) ----------------------------------------------


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) quaternion (x, y, z, w), Shepperd's method."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    trace = m00 + m11 + m22

    def sq(x):
        return 0.5 * torch.sqrt(torch.clamp(x, min=1e-12))

    w = sq(1.0 + trace)
    c0 = torch.stack([(m21 - m12) * 0.25 / w, (m02 - m20) * 0.25 / w,
                      (m10 - m01) * 0.25 / w, w], -1)
    x = sq(1.0 + m00 - m11 - m22)
    c1 = torch.stack([x, (m01 + m10) * 0.25 / x, (m02 + m20) * 0.25 / x,
                      (m21 - m12) * 0.25 / x], -1)
    y = sq(1.0 - m00 + m11 - m22)
    c2 = torch.stack([(m01 + m10) * 0.25 / y, y, (m12 + m21) * 0.25 / y,
                      (m02 - m20) * 0.25 / y], -1)
    z = sq(1.0 - m00 - m11 + m22)
    c3 = torch.stack([(m02 + m20) * 0.25 / z, (m12 + m21) * 0.25 / z, z,
                      (m10 - m01) * 0.25 / z], -1)
    q = torch.where((trace > 0.0)[..., None], c0, torch.where(
        ((m00 >= m11) & (m00 >= m22))[..., None], c1,
        torch.where((m11 >= m22)[..., None], c2, c3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], dim=-2)
