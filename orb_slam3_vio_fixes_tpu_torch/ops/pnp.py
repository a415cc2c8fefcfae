"""Batched maximum-likelihood PnP RANSAC: camera pose from 3D-2D matches
(port of orb_slam3_vio_fixes_tpu/ops/pnp.py).

H 6-point sets are solved as one batch of DLT projection matrices (12x12
eigendecompositions) and scored against all points in one (H, N) pass; the
top hypotheses get the MLPnP Gauss-Newton polish on bearing-vector nullspace
residuals, weighted by the octave information. As in ops/sim3.py the RANSAC
is split into a sampler on an explicit `torch.Generator` and `pnp_from_samples`,
which scores given (H, 6) index sets.

One deliberate difference: the DLT's null vector is defined up to sign, and
the reference keeps whatever sign the eigensolver returns, so a hypothesis
whose P comes out negated yields a mirrored rotation that the cheirality
gate then rejects. The port flips P to det(P[:, :3]) > 0, so every
hypothesis is usable; with the polish both reach the same optimum.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_vio_fixes_tpu_torch.ops.sim3 import sample
from orb_slam3_vio_fixes_tpu_torch.utils import lie
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera
from orb_slam3_vio_fixes_tpu_torch.utils.linalg import solve6, take, topk_stable

CHI2_2D = 5.991


def _dlt_p(X, xn):
    """Batched 6-point DLT: X (H, 6, 3), xn (H, 6, 2) -> P (H, 3, 4) with
    det(P[:, :3]) >= 0."""
    H = X.shape[0]
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], -1)
    zero = torch.zeros_like(Xh)
    u, v = xn[..., 0:1], xn[..., 1:2]
    A = torch.cat([torch.cat([Xh, zero, -u * Xh], -1),
                   torch.cat([zero, Xh, -v * Xh], -1)], -2)      # (H, 12, 12)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    P = vecs[..., 0].reshape(H, 3, 4)
    sgn = torch.where(torch.linalg.det(P[:, :, :3]) < 0, -1.0, 1.0)
    return P * sgn[:, None, None]


def _extract_rt(P):
    """Nearest rotation and scale of P[:, :3] ~ sR; t = P[:, 3] / s."""
    u, s, vt = torch.linalg.svd(P[:, :, :3])
    det = torch.linalg.det(u @ vt)
    fix = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    R = u @ (fix[..., :, None] * vt)
    scale = s.mean(-1) * torch.sign(det)
    scale = torch.where(scale.abs() > 1e-9, scale, torch.full_like(scale, 1e-9))
    return R, P[:, :, 3] / scale[:, None]


def bearing_tangent_basis(v):
    """Orthonormal tangent basis (r, s) of unit bearings v (N, 3)."""
    ex = torch.tensor([1.0, 0.0, 0.0], device=v.device).expand_as(v)
    ey = torch.tensor([0.0, 1.0, 0.0], device=v.device).expand_as(v)
    ax = torch.where(v[:, 0:1].abs() < 0.9, ex, ey)
    r = torch.linalg.cross(v, ax)
    r = r / torch.clamp(torch.linalg.norm(r, dim=-1, keepdim=True), min=1e-12)
    return r, torch.linalg.cross(v, r)


def mlpnp_gn(R, t, X, r_b, s_b, w, iters: int = 8):
    """Gauss-Newton on bearing nullspace residuals, batched over hypotheses:
    R (B, 3, 3), t (B, 3), X (N, 3), r_b / s_b (N, 3) tangent bases of the
    observed bearings, w (B, N) information (0 = excluded)."""
    eye3 = torch.eye(3, device=X.device)
    eye6 = torch.eye(6, device=X.device)
    for _ in range(iters):
        q = X @ R.transpose(-1, -2)                        # (B, N, 3)
        u = q + t[:, None, :]
        un = torch.clamp(torch.linalg.norm(u, dim=-1, keepdim=True), min=1e-9)
        uh = u / un
        res = torch.stack([(r_b * uh).sum(-1), (s_b * uh).sum(-1)], -1)
        P = (eye3 - uh[..., :, None] * uh[..., None, :]) / un[..., None]
        Jr = (r_b[None, :, None, :] @ P)[..., 0, :]       # (B, N, 3)
        Js = (s_b[None, :, None, :] @ P)[..., 0, :]
        J = torch.stack([torch.cat([torch.linalg.cross(q, Jr), Jr], -1),
                         torch.cat([torch.linalg.cross(q, Js), Js], -1)], -2)
        Jw = J * w[..., None, None]                        # (B, N, 2, 6)
        H = torch.einsum("bnri,bnrj->bij", Jw, J)
        g = torch.einsum("bnri,bnr->bi", Jw, res)
        dx = solve6(H + 1e-8 * eye6, -g)
        R = lie.so3_normalize(lie.so3_exp(dx[:, :3]) @ R)
        t = t + dx[:, 3:]
    return R, t


class PnPResult(NamedTuple):
    success: torch.Tensor    # bool
    R: torch.Tensor          # (3, 3) world -> camera
    t: torch.Tensor          # (3,)
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # int


def pnp_from_samples(idx, X, uv, valid, inv_sigma2, cam: Camera,
                     min_inliers: int = 10, n_refine: int = 4,
                     gn_iters: int = 8) -> PnPResult:
    """Solve and score the (H, 6) hypotheses `idx`, polish the top
    `n_refine`, and keep the refined best unless an unrefined one scores
    more."""
    n = X.shape[0]
    xn_all = torch.stack([(uv[:, 0] - cam.cx) / cam.fx,
                          (uv[:, 1] - cam.cy) / cam.fy], -1)
    R, t = _extract_rt(_dlt_p(X[idx], xn_all[idx]))

    def score(R, t):
        Xc = X @ R.transpose(-1, -2) + t[:, None, :]
        z = Xc[..., 2]
        zc = torch.clamp(z, min=1e-6)
        uvp = torch.stack([cam.fx * Xc[..., 0] / zc + cam.cx,
                           cam.fy * Xc[..., 1] / zc + cam.cy], -1)
        err2 = ((uvp - uv[None]) ** 2).sum(-1) * inv_sigma2[None]
        inl = (z > 0.05) & valid[None, :] & (err2 < CHI2_2D)
        return inl, inl.sum(-1)

    inl, n_inl = score(R, t)
    _, top = topk_stable(n_inl, n_refine)
    bear = torch.cat([xn_all, torch.ones((n, 1), device=X.device)], -1)
    bear = bear / torch.linalg.norm(bear, dim=-1, keepdim=True)
    r_b, s_b = bearing_tangent_basis(bear)
    w_all = inv_sigma2 * (cam.fx * cam.fy) * valid.to(torch.float32)
    R_ref, t_ref = mlpnp_gn(R[top], t[top], X, r_b, s_b,
                            w_all[None] * inl[top].to(torch.float32), gn_iters)
    inl_ref, n_ref = score(R_ref, t_ref)
    ib = torch.argmax(n_ref)
    bu = torch.argmax(n_inl)
    n_ib, n_bu = take(n_ref, ib), take(n_inl, bu)
    use_ref = n_ib >= n_bu
    return PnPResult(
        success=torch.where(use_ref, n_ib, n_bu) >= min_inliers,
        R=torch.where(use_ref, take(R_ref, ib), take(R, bu)),
        t=torch.where(use_ref, take(t_ref, ib), take(t, bu)),
        inliers=torch.where(use_ref, take(inl_ref, ib), take(inl, bu)),
        n_inliers=torch.where(use_ref, n_ib, n_bu))


def pnp_ransac(gen: torch.Generator, X, uv, valid, inv_sigma2, cam: Camera,
               n_hyp: int = 256, min_inliers: int = 10, n_refine: int = 4,
               gn_iters: int = 8) -> PnPResult:
    """All-hypothesis ML-PnP RANSAC over 6-point samples of the valid rows."""
    idx = sample(gen, valid, n_hyp, 6)
    return pnp_from_samples(idx, X, uv, valid, inv_sigma2, cam, min_inliers,
                            n_refine, gn_iters)
