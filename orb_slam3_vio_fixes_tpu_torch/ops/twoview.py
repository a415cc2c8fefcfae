"""Monocular map initialisation: two-view reconstruction by batched RANSAC
(port of orb_slam3_vio_fixes_tpu/ops/twoview.py).

200 hypotheses of 8 correspondences each give a fundamental matrix and a
homography (one batched 9x9 eigendecomposition per model), every hypothesis
is scored against all matches in one (H, N) pass, and the 4 motions of the
best F (through E) and the 8 of the best H are checked in one batched
CheckRT over all 12 candidates. As in ops/sim3.py the sampling is split
off: `sample` draws the (H, 8) index sets from an explicit
`torch.Generator` (the reference draws them with `jax.random.categorical`),
so both packages can be fed the same draws.

The solves run in full float32: the trackers turn TF32 off
(`ba_core.set_full_f32`) before any of this runs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_vio_fixes_tpu_torch.ops.sim3 import sample
from orb_slam3_vio_fixes_tpu_torch.ops.triangulate import triangulate_dlt
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera, project
from orb_slam3_vio_fixes_tpu_torch.utils.linalg import inv3

TH_F = 3.841   # chi2 1-DoF 95%
TH_H = 5.991   # chi2 2-DoF 95%
TH_SCORE = 5.991

# the essential matrix's W and the sign pattern of the homography's
# sin(theta) over its four (x1, x3) sign combinations
_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))
_ST_SIGNS = (1.0, -1.0, -1.0, 1.0)
_X1_SIGNS = (1.0, 1.0, -1.0, -1.0)
_X3_SIGNS = (1.0, -1.0, 1.0, -1.0)


def _normalize(uv, valid):
    """Zero-mean, unit mean-absolute-deviation normalisation over the valid
    rows. Returns (normalised uv, T)."""
    n = torch.clamp(valid.sum(), min=1).to(uv.dtype)
    v = valid[:, None]
    zero = torch.zeros_like(uv)
    mean = torch.where(v, uv, zero).sum(0) / n
    dev = torch.where(v, (uv - mean).abs(), zero).sum(0) / n
    s = 1.0 / torch.clamp(dev, min=1e-9)
    uvn = (uv - mean) * s
    z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]),
                     torch.stack([z, s[1], -mean[1] * s[1]]),
                     torch.stack([z, z, o])])
    return uvn, T


def _smallest_eigvec(A):
    """(H, n, 9) design matrices -> (H, 3, 3) from the eigenvector of A^T A
    with the smallest eigenvalue."""
    AtA = A.transpose(-1, -2) @ A
    _, v = torch.linalg.eigh(AtA)
    return v[..., 0].reshape(-1, 3, 3)


def _dlt_f(p1, p2):
    """8-point fundamental: (H, 8, 2) x2 -> (H, 3, 3), rank 2 enforced."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)
    f = _smallest_eigvec(A)
    u, s, vt = torch.linalg.svd(f)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return (u * s[..., None, :]) @ vt


def _dlt_h(p1, p2):
    """Homography from the same 8-point sets by DLT: (H, 3, 3)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z, o = torch.zeros_like(x1), torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    return _smallest_eigvec(torch.cat([r1, r2], dim=-2))


def _homog(uv):
    return torch.cat([uv, torch.ones_like(uv[:, :1])], dim=-1)


def _score(d1, d2, th, valid):
    """Symmetric transfer score of (H, N) squared errors and the inliers."""
    in1, in2 = d1 < th, d2 < th
    zero = torch.zeros_like(d1)
    sc = torch.where(in1, TH_SCORE - d1, zero) + torch.where(in2, TH_SCORE - d2, zero)
    sc = torch.where(valid[None], sc, zero)
    return sc.sum(-1), in1 & in2 & valid[None]


def _score_f(F, uv1, uv2, valid):
    """Symmetric epipolar distance score of (H, 3, 3) fundamentals."""
    p1, p2 = _homog(uv1), _homog(uv2)
    l2 = torch.einsum("hij,nj->hni", F, p1)     # lines in image 2
    l1 = torch.einsum("hji,nj->hni", F, p2)     # lines in image 1
    d2 = (l2 * p2[None]).sum(-1) ** 2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2,
                                                    min=1e-12)
    d1 = (l1 * p1[None]).sum(-1) ** 2 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2,
                                                    min=1e-12)
    return _score(d1, d2, TH_F, valid)


def _dehomog(p):
    w = p[..., 2:]
    return p[..., :2] / torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)


def _score_h(H, uv1, uv2, valid):
    """Symmetric transfer score of (H, 3, 3) homographies."""
    p1, p2 = _homog(uv1), _homog(uv2)
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    q2 = _dehomog(torch.einsum("hij,nj->hni", H, p1))
    q1 = _dehomog(torch.einsum("hij,nj->hni", inv3(H + 1e-12 * eye), p2))
    d2 = ((q2 - uv2[None]) ** 2).sum(-1)
    d1 = ((q1 - uv1[None]) ** 2).sum(-1)
    return _score(d1, d2, TH_H, valid)


def _motions_from_e(E):
    """The 4 motion hypotheses (R1, R1, R2, R2) x (t, -t) of an essential
    matrix: (4, 3, 3), (4, 3)."""
    u, _, vt = torch.linalg.svd(E)
    u = u * torch.sign(torch.linalg.det(u))
    vt = vt * torch.sign(torch.linalg.det(vt))
    W = torch.tensor(_W, dtype=E.dtype, device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _motions_from_h(Hm, K):
    """The 8 motion hypotheses of a homography by Faugeras' SVD method,
    d' = d2 first, then d' = -d2: (8, 3, 3), (8, 3) unit translations."""
    A = inv3(K) @ Hm @ K
    U, w, Vt = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = w[0], w[1], w[2]
    den = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den, min=0.0))
    dev, dt = Hm.device, Hm.dtype
    x1 = aux1 * torch.tensor(_X1_SIGNS, dtype=dt, device=dev)
    x3 = aux3 * torch.tensor(_X3_SIGNS, dtype=dt, device=dev)
    st_sign = torch.tensor(_ST_SIGNS, dtype=dt, device=dev)
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    zero, one = torch.zeros_like(x1), torch.ones_like(x1)
    # d' = d2
    den_p = torch.clamp((d1 + d3) * d2, min=1e-12)
    st = st_sign * (root / den_p)
    ct = ((d2 * d2 + d1 * d3) / den_p).expand(4)
    Rp_a = torch.stack([torch.stack([ct, zero, -st], -1), torch.stack([zero, one, zero], -1),
                        torch.stack([st, zero, ct], -1)], -2)
    tp_a = (d1 - d3) * torch.stack([x1, zero, -x3], -1)
    # d' = -d2
    den_m = torch.clamp((d1 - d3) * d2, min=1e-12)
    sp = st_sign * (root / den_m)
    cp = ((d1 * d3 - d2 * d2) / den_m).expand(4)
    Rp_b = torch.stack([torch.stack([cp, zero, sp], -1), torch.stack([zero, -one, zero], -1),
                        torch.stack([sp, zero, -cp], -1)], -2)
    tp_b = (d1 + d3) * torch.stack([x1, zero, x3], -1)
    Rp = torch.cat([Rp_a, Rp_b])
    tp = torch.cat([tp_a, tp_b])
    R = s * (U @ Rp @ Vt)
    t = tp @ U.T
    return R, t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)


def _check_rt(R, t, uv1, uv2, rays1, rays2, inliers, cam: Camera, sigma2: float = 1.0):
    """Triangulate the matches with each of C candidate motions and keep
    the good points: finite, in front of both cameras, enough parallax,
    reprojection within 4 sigma^2 in both views. R (C, 3, 3), t (C, 3).
    Returns (ok (C, N), Xw (C, N, 3), the cosine of the 50th-best parallax
    (C,))."""
    C, n = R.shape[0], uv1.shape[0]
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(C, n, 3, 3)
    Xw = triangulate_dlt(eye, torch.zeros(C, n, 3, dtype=R.dtype, device=R.device),
                         R[:, None].expand(C, n, 3, 3), t[:, None].expand(C, n, 3),
                         rays1.expand(C, n, 3), rays2.expand(C, n, 3))
    finite = torch.isfinite(Xw).all(-1)
    Xc2 = Xw @ R.transpose(-1, -2) + t[:, None]
    C2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    n2 = Xw - C2[:, None]
    cosp = (Xw * n2).sum(-1) / torch.clamp(
        torch.linalg.norm(Xw, dim=-1) * torch.linalg.norm(n2, dim=-1), min=1e-12)
    e1 = project(cam, Xw) - uv1
    e2 = project(cam, Xc2) - uv2
    ok = (finite & inliers & (Xw[..., 2] > 0) & (Xc2[..., 2] > 0) & (cosp < 0.99998)
          & ((e1 * e1).sum(-1) < 4.0 * sigma2) & ((e2 * e2).sum(-1) < 4.0 * sigma2))
    good_parallax = torch.sort(torch.where(ok, cosp, torch.ones_like(cosp)), dim=-1)[0]
    idx50 = torch.clamp(ok.sum(-1) - 1, min=0).clamp(max=50)
    return ok, Xw, torch.gather(good_parallax, 1, idx50[:, None])[:, 0]


class TwoViewResult(NamedTuple):
    success: torch.Tensor          # () bool
    R: torch.Tensor                # (3, 3) T_21 rotation
    t: torch.Tensor                # (3,) unit-norm translation
    points: torch.Tensor           # (N, 3) points in the first camera (= world)
    good: torch.Tensor             # (N,) bool triangulated
    used_homography: torch.Tensor  # () bool


def reconstruct(gen: torch.Generator, uv1, uv2, valid, cam: Camera, n_hyp: int = 200,
                min_triangulated: int = 50) -> TwoViewResult:
    """Two-view initialisation from matched keypoints uv1 (first frame) and
    uv2 (second frame), (N, 2) each, `valid` (N,): F and H RANSAC, the model
    with SH / (SH + SF) > 0.5 wins, its motions checked, success with at
    least `min_triangulated` good points, one clear winner, enough parallax
    and most inliers triangulated. No host sync."""
    n = uv1.shape[0]
    uv1n, T1 = _normalize(uv1, valid)
    uv2n, T2 = _normalize(uv2, valid)
    idx = sample(gen, valid, n_hyp, 8)
    p1, p2 = uv1n[idx], uv2n[idx]
    Fn = _dlt_f(p1, p2)
    Hn = _dlt_h(p1, p2)
    F = T2.T @ Fn @ T1
    Hm = inv3(T2) @ Hn @ T1
    sf, inl_f = _score_f(F, uv1, uv2, valid)
    sh, inl_h = _score_h(Hm, uv1, uv2, valid)
    bf_i = torch.argmax(sf)
    bh_i = torch.argmax(sh)
    SF, SH = sf[bf_i], sh[bh_i]
    use_h = SH / torch.clamp(SH + SF, min=1e-9) > 0.5

    dev = uv1.device
    K = torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
                     dtype=torch.float32, device=dev)
    c = torch.tensor([cam.cx, cam.cy], dtype=torch.float32, device=dev)
    f = torch.tensor([cam.fx, cam.fy], dtype=torch.float32, device=dev)
    ones = torch.ones((n, 1), dtype=torch.float32, device=dev)
    rays1 = torch.cat([(uv1 - c) / f, ones], -1)
    rays2 = torch.cat([(uv2 - c) / f, ones], -1)

    Rf, tf = _motions_from_e(K.T @ F[bf_i] @ K)
    Rh, th = _motions_from_h(Hm[bh_i], K)
    Rs = torch.cat([Rf, Rh])
    ts = torch.cat([tf, th])
    is_e = torch.arange(12, device=dev) < 4
    cand_active = torch.where(use_h, ~is_e, is_e)
    inliers = torch.where(use_h, inl_h[bh_i], inl_f[bf_i])

    ok_all, Xw_all, par_all = _check_rt(Rs, ts, uv1, uv2, rays1, rays2, inliers, cam)
    n_good = torch.where(cand_active, ok_all.sum(-1), torch.full_like(ok_all[:, 0], -1,
                                                                       dtype=torch.int64))
    best = torch.argmax(n_good)
    n_best = n_good[best]
    similar = (n_good > 0.75 * n_best).sum()
    success = ((n_best >= min_triangulated) & (similar == 1) & (par_all[best] < 0.9998)
               & (n_best > 0.8 * torch.clamp(inliers.sum(), min=1)))
    return TwoViewResult(success=success, R=Rs[best], t=ts[best], points=Xw_all[best],
                         good=ok_all[best], used_homography=use_h)
