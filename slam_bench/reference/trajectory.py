"""Plain reference of trajectory errors against the generator's ground
truth: relative pose errors between consecutive poses, and Horn's aligned
absolute error (the ATE of the TUM / EuRoC evaluation scripts) with its
rotation, in float64 numpy."""

from __future__ import annotations

import numpy as np


def relative_errors(R_cw, t_cw, R_wc_gt, t_wc_gt):
    """Per consecutive pair (i, i + 1): the rotation angle (degrees) and the
    translation length (metres) of the difference between the estimated
    and the true motion of camera i + 1 relative to camera i. The estimate
    is given world -> camera, the truth camera -> world; both are free of
    the world frame's choice."""
    R_cw, t_cw = np.asarray(R_cw, np.float64), np.asarray(t_cw, np.float64)
    R_wc, t_wc = np.asarray(R_wc_gt, np.float64), np.asarray(t_wc_gt, np.float64)
    # estimate: T_{i+1,i} = T_cw(i+1) T_cw(i)^-1
    dR_e = R_cw[1:] @ np.transpose(R_cw[:-1], (0, 2, 1))
    dt_e = t_cw[1:] - (dR_e @ t_cw[:-1, :, None])[..., 0]
    # truth: T_{i+1,i} = T_wc(i+1)^-1 T_wc(i)
    dR_g = np.transpose(R_wc[1:], (0, 2, 1)) @ R_wc[:-1]
    dt_g = (np.transpose(R_wc[1:], (0, 2, 1)) @ (t_wc[:-1] - t_wc[1:])[..., None])[..., 0]
    E = np.transpose(dR_g, (0, 2, 1)) @ dR_e
    # the angle of E from both its sine and its cosine, exact near zero
    s = 0.5 * np.linalg.norm(np.stack([E[:, 2, 1] - E[:, 1, 2], E[:, 0, 2] - E[:, 2, 0],
                                       E[:, 1, 0] - E[:, 0, 1]], 1), axis=1)
    c = 0.5 * (np.trace(E, axis1=1, axis2=2) - 1.0)
    return np.degrees(np.arctan2(s, c)), np.linalg.norm(dt_e - dt_g, axis=1)


def rms(x) -> float:
    x = np.asarray(x, np.float64)
    return float(np.sqrt(np.mean(x * x))) if x.size else float("nan")


def horn_rotation(est_c, gt_c) -> np.ndarray:
    """The rotation of the least-squares rigid alignment of the estimated
    camera centres onto the true ones (Horn 1987, closed form by SVD)."""
    est_c, gt_c = np.asarray(est_c, np.float64), np.asarray(gt_c, np.float64)
    W = (gt_c - gt_c.mean(0)).T @ (est_c - est_c.mean(0))
    U, _, Vt = np.linalg.svd(W)
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1.0
    return U @ D @ Vt


def horn_ate(est_c, gt_c) -> float:
    """RMS distance of the estimated camera centres after the least-squares
    rigid alignment onto the true ones."""
    est_c, gt_c = np.asarray(est_c, np.float64), np.asarray(gt_c, np.float64)
    R = horn_rotation(est_c, gt_c)
    err = (est_c - est_c.mean(0)) @ R.T + gt_c.mean(0) - gt_c
    return float(np.sqrt((err * err).sum(1).mean()))
