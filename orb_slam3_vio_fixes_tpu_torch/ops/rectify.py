"""Stereo rectification and radial-tangential undistortion (port of
orb_slam3_vio_fixes_tpu/ops/rectify.py).

The maps are computed once on the host in numpy (the reference's functions,
unchanged); the per-frame remaps are plain PyTorch gathers with the
reference's index arithmetic written out (floor / round, 0 outside the
image), which `F.grid_sample`'s align-corners and padding conventions would
not reproduce. The remaps are not TPU kernels in the reference either.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


def radtan_distort(xy: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """Apply distortion to normalised coords. xy: (..., 2); dist: (4,) or (5,)."""
    d = np.zeros(5)
    d[: len(dist)] = dist
    k1, k2, p1, p2, k3 = d
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd, yd], axis=-1)


def undistort_points(uv: np.ndarray, K: np.ndarray, dist: np.ndarray,
                     R: Optional[np.ndarray] = None, P: Optional[np.ndarray] = None,
                     n_iters: int = 10) -> np.ndarray:
    """cv::undistortPoints analogue (fixed-point iteration): pixel coords ->
    undistorted, optionally rotated by R and reprojected by the 3x3 P."""
    uv = np.asarray(uv, np.float64)
    x = (uv[..., 0] - K[0, 2]) / K[0, 0]
    y = (uv[..., 1] - K[1, 2]) / K[1, 1]
    x0, y0 = x.copy(), y.copy()
    d = np.zeros(5)
    d[: len(dist)] = dist
    k1, k2, p1, p2, k3 = d
    for _ in range(n_iters):
        # distorted(x) = x * radial + tang  =>  x = (x0 - tang) / radial
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        tx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        ty = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - tx) / radial
        y = (y0 - ty) / radial
    pts = np.stack([x, y, np.ones_like(x)], axis=-1)
    if R is not None:
        pts = pts @ np.asarray(R, np.float64).T
    pts = pts[..., :2] / pts[..., 2:3]
    if P is not None:
        P = np.asarray(P, np.float64)
        return np.stack([P[0, 0] * pts[..., 0] + P[0, 2],
                         P[1, 1] * pts[..., 1] + P[1, 2]], axis=-1)
    return pts


def _rodrigues(r: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(r)
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)


def _log_so3(R: np.ndarray) -> np.ndarray:
    c = max(-1.0, min(1.0, (np.trace(R) - 1.0) / 2.0))
    th = np.arccos(c)
    if th < 1e-12:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / (2 * np.sin(th))
    return w * th


class StereoRectification(NamedTuple):
    R1: np.ndarray    # rectifying rotation, cam1 (R_r1_u1)
    R2: np.ndarray    # rectifying rotation, cam2
    P1: np.ndarray    # (3, 4) new projection, cam1
    P2: np.ndarray    # (3, 4) new projection, cam2
    Q: np.ndarray     # (4, 4) disparity-to-depth
    map1: np.ndarray  # (H, W, 2) float32 source coords for the cam1 remap
    map2: np.ndarray  # (H, W, 2) for cam2

    @property
    def fx(self) -> float:
        return float(self.P1[0, 0])

    @property
    def baseline(self) -> float:
        return float(abs(self.P2[0, 3]) / self.P2[0, 0])


def stereo_rectify(K1: np.ndarray, dist1: np.ndarray, K2: np.ndarray, dist2: np.ndarray,
                   size: Tuple[int, int], T_c1_c2: np.ndarray) -> StereoRectification:
    """cv::stereoRectify(CALIB_ZERO_DISPARITY, alpha=-1) analogue. size:
    (width, height); T_c1_c2: 4x4 pose of cam2 in cam1."""
    w, h = size
    T_c2_c1 = np.linalg.inv(np.asarray(T_c1_c2, np.float64))
    R = T_c2_c1[:3, :3]
    T = T_c2_c1[:3, 3]
    # split the relative rotation evenly between the eyes
    om = _log_so3(R)
    r_r = _rodrigues(-om / 2)
    t = r_r @ T
    # rotate so the baseline is horizontal
    idx = 0 if abs(t[0]) > abs(t[1]) else 1
    uu = np.zeros(3)
    uu[idx] = 1.0 if t[idx] > 0 else -1.0
    ww = np.cross(t, uu)
    nw = np.linalg.norm(ww)
    if nw > 1e-15:
        ww *= np.arccos(abs(t[idx]) / np.linalg.norm(t)) / nw
    wR = _rodrigues(ww)
    R1 = wR @ r_r.T
    R2 = wR @ r_r
    # new focal: fy shrunk by the worst-case barrel distortion (OpenCV rule)
    fc_new = np.inf
    for K, dist in ((K1, dist1), (K2, dist2)):
        dk1 = dist[0] if len(dist) else 0.0
        fc = K[1, 1]
        if dk1 < 0:
            fc *= 1 + dk1 * (w * w + h * h) / (4 * fc * fc)
        fc_new = min(fc_new, fc)
    # new principal point: the mean of the undistorted, rotated corners
    cc = []
    for K, dist, Rk in ((K1, dist1, R1), (K2, dist2, R2)):
        corners = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]], np.float64)
        avg = undistort_points(corners, K, dist, R=Rk).mean(0)
        cc.append(np.array([(w - 1) / 2, (h - 1) / 2]) - avg * fc_new)
    # CALIB_ZERO_DISPARITY: both eyes share the principal point
    cc_new = np.asarray(cc).mean(0)
    P1 = np.array([[fc_new, 0, cc_new[0], 0], [0, fc_new, cc_new[1], 0], [0, 0, 1, 0]])
    P2 = P1.copy()
    tsign = np.sign(t[idx]) if t[idx] != 0 else 1.0
    P2[idx, 3] = tsign * np.linalg.norm(t) * fc_new
    baseline = abs(P2[idx, 3]) / fc_new
    Q = np.array([[1, 0, 0, -cc_new[0]], [0, 1, 0, -cc_new[1]], [0, 0, 0, fc_new],
                  [0, 0, -tsign / baseline, 0]])
    map1 = init_undistort_rectify_map(K1, dist1, R1, P1[:, :3], (w, h))
    map2 = init_undistort_rectify_map(K2, dist2, R2, P2[:, :3], (w, h))
    return StereoRectification(R1, R2, P1, P2, Q, map1, map2)


def init_undistort_rectify_map(K: np.ndarray, dist: np.ndarray, R: np.ndarray,
                               P_new: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv::initUndistortRectifyMap analogue: (H, W, 2) float32 source pixels
    (normalise by P_new, rotate back by R^T, distort, project by K)."""
    w, h = size
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    x = (u - P_new[0, 2]) / P_new[0, 0]
    y = (v - P_new[1, 2]) / P_new[1, 1]
    pts = np.stack([x, y, np.ones_like(x)], axis=-1) @ R  # == (R^T p)^T rows
    xyd = radtan_distort(pts[..., :2] / pts[..., 2:3], np.asarray(dist, np.float64))
    su = K[0, 0] * xyd[..., 0] + K[0, 2]
    sv = K[1, 1] * xyd[..., 1] + K[1, 2]
    return np.stack([su, sv], axis=-1).astype(np.float32)


def remap_nearest(img: torch.Tensor, srcmap: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour remap (depth maps: bilinear blending across depth
    edges would invent surfaces). Out-of-image samples read 0."""
    H, W = img.shape[-2:]
    xi = torch.round(srcmap[..., 0]).to(torch.int64)
    yi = torch.round(srcmap[..., 1]).to(torch.int64)
    inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    vals = img[..., yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
    return torch.where(inside, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))


def remap_bilinear(img: torch.Tensor, srcmap: torch.Tensor) -> torch.Tensor:
    """Bilinear remap (cv::remap analogue). img: (H, W) or (B, H, W) float;
    srcmap: (H', W', 2) source pixel coords (x, y). Out-of-image taps read 0
    (cv BORDER_CONSTANT)."""
    im = img if img.ndim == 3 else img[None]
    _, H, W = im.shape
    sx, sy = srcmap[..., 0], srcmap[..., 1]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    zero = torch.zeros((), dtype=im.dtype, device=im.device)

    def tap(yy, xx):
        inside = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        return torch.where(inside[None], im[:, yy.clamp(0, H - 1), xx.clamp(0, W - 1)], zero)

    out = (tap(y0i, x0i) * (1 - fx) * (1 - fy) + tap(y0i, x0i + 1) * fx * (1 - fy)
           + tap(y0i + 1, x0i) * (1 - fx) * fy + tap(y0i + 1, x0i + 1) * fx * fy)
    return out if img.ndim == 3 else out[0]
