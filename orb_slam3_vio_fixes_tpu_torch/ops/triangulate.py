"""Triangulation: batched DLT, ray midpoint, stereo back-projection and the
new-landmark acceptance gates (port of orb_slam3_vio_fixes_tpu/ops/triangulate.py).
"""

from __future__ import annotations

import torch

from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera, project, unproject
from orb_slam3_vio_fixes_tpu_torch.utils.linalg import inv3


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _mtv(A, x):
    return (A.transpose(-1, -2) @ x[..., None])[..., 0]


def triangulate_dlt(R1, t1, R2, t2, ray1, ray2):
    """DLT with the homogeneous scale pinned to 1: the 3x3 normal equations
    of A[:, :3] X = -A[:, 3], solved in closed form with a tiny relative
    ridge (the reference's formulation)."""
    P1 = torch.cat([R1, t1[..., None]], dim=-1)
    P2 = torch.cat([R2, t2[..., None]], dim=-1)
    rows = []
    for P, ray in ((P1, ray1), (P2, ray2)):
        x = ray[..., 0] / ray[..., 2]
        y = ray[..., 1] / ray[..., 2]
        rows.append(x[..., None] * P[..., 2, :] - P[..., 0, :])
        rows.append(y[..., None] * P[..., 2, :] - P[..., 1, :])
    A = torch.stack(rows, dim=-2)
    A3 = A[..., :3]
    a4 = A[..., 3]
    M = A3.transpose(-1, -2) @ A3
    b = -_mtv(A3, a4)
    tr = M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2]
    eye = torch.eye(3, dtype=M.dtype, device=M.device)
    eps = (1e-9 * tr + 1e-20)[..., None, None] * eye
    return _mv(inv3(M + eps), b)


def triangulate_midpoint(R1, t1, R2, t2, ray1, ray2):
    """Closed-form two-ray midpoint (same interface as triangulate_dlt)."""
    C1 = -_mtv(R1, t1)
    C2 = -_mtv(R2, t2)
    d1 = _mtv(R1, ray1)
    d2 = _mtv(R2, ray2)
    b = C2 - C1
    a11 = (d1 * d1).sum(-1)
    a22 = (d2 * d2).sum(-1)
    a12 = (d1 * d2).sum(-1)
    e1 = (d1 * b).sum(-1)
    e2 = (d2 * b).sum(-1)
    den = a11 * a22 - a12 * a12
    den = torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
    s = (e1 * a22 - a12 * e2) / den
    u = (e1 * a12 - a11 * e2) / den
    return 0.5 * ((C1 + s[..., None] * d1) + (C2 + u[..., None] * d2))


def stereo_backproject(cam: Camera, bf: float, uv, ur):
    """z = bf / (uL - uR); returns (camera-frame point, z)."""
    disp = uv[..., 0] - ur
    z = bf / torch.where(disp.abs() < 1e-6, torch.full_like(disp, 1e-6), disp)
    return unproject(cam, uv) * z[..., None], z


def triangulation_checks(cam: Camera, R1, t1, R2, t2, uv1, uv2, Xw, octave1,
                         octave2, scale_factors, sigma2_factors,
                         chi2_th: float = 5.991,
                         min_parallax_cos: float = 0.9998):
    """Positive depth in both views, per-octave reprojection chi2, parallax,
    scale consistency."""
    n_sf = sigma2_factors.shape[0]
    Xc1 = _mv(R1, Xw) + t1
    Xc2 = _mv(R2, Xw) + t2
    z_ok = (Xc1[..., 2] > 0) & (Xc2[..., 2] > 0)
    e1 = project(cam, Xc1) - uv1
    e2 = project(cam, Xc2) - uv2
    o1 = octave1.to(torch.int64).clamp(0, n_sf - 1)
    o2 = octave2.to(torch.int64).clamp(0, n_sf - 1)
    reproj_ok = (((e1 * e1).sum(-1) / sigma2_factors[o1] < chi2_th)
                 & ((e2 * e2).sum(-1) / sigma2_factors[o2] < chi2_th))
    C1 = -_mtv(R1, t1)
    C2 = -_mtv(R2, t2)
    r1 = Xw - C1
    r2 = Xw - C2
    n1 = torch.linalg.norm(r1, dim=-1)
    n2 = torch.linalg.norm(r2, dim=-1)
    cos_par = (r1 * r2).sum(-1) / torch.clamp(n1 * n2, min=1e-9)
    parallax_ok = cos_par < min_parallax_cos
    ratio_dist = n2 / torch.clamp(n1, min=1e-9)
    ratio_oct = scale_factors[o1] / scale_factors[o2]
    rf = 1.5 * 1.2
    scale_ok = (ratio_dist * rf > ratio_oct) & (ratio_dist < ratio_oct * rf)
    return z_ok & reproj_ok & parallax_ok & scale_ok
