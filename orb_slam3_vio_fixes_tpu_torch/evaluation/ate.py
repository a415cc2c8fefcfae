"""Trajectory evaluation: Horn alignment + RMS ATE (+ optimal scale).

Re-implementation of the metric defined by the reference's evaluation harness
(reference semantics: evaluation/evaluate_ate_scale.py:49-97 `align` — Horn
closed-form SE(3) alignment with optional optimal scale for monocular —
and :162 RMS ATE; association by nearest timestamp like
evaluation/associate.py). Written fresh in numpy.
"""

from __future__ import annotations

import numpy as np


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02):
    """Greedy nearest-timestamp association. Returns index pairs (ia, ib)."""
    ia, ib = [], []
    j = 0
    for i, ta in enumerate(ts_a):
        j = int(np.searchsorted(ts_b, ta))
        best, bestd = -1, max_dt
        for cand in (j - 1, j):
            if 0 <= cand < len(ts_b):
                d = abs(ts_b[cand] - ta)
                if d <= bestd:
                    best, bestd = cand, d
        if best >= 0:
            ia.append(i)
            ib.append(best)
    return np.asarray(ia, int), np.asarray(ib, int)


def horn_align(model: np.ndarray, data: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (or similarity) alignment model -> data.

    model, data: (N, 3). Returns (s, R, t) with data ≈ s R model + t.
    """
    mu_m = model.mean(0)
    mu_d = data.mean(0)
    mc = model - mu_m
    dc = data - mu_d
    W = dc.T @ mc
    U, S, Vt = np.linalg.svd(W)
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    if with_scale:
        s = float(np.trace(np.diag(S) @ D) / (mc**2).sum())
    else:
        s = 1.0
    t = mu_d - s * R @ mu_m
    return s, R, t


def ate_rmse(
    gt_ts, gt_pos, est_ts, est_pos, with_scale: bool = False, max_dt: float = 0.02
):
    """RMS absolute trajectory error after alignment. Returns (rmse, scale, n)."""
    ia, ib = associate(np.asarray(gt_ts), np.asarray(est_ts), max_dt)
    if len(ia) < 3:
        return np.inf, 1.0, len(ia)
    gt = np.asarray(gt_pos)[ia]
    est = np.asarray(est_pos)[ib]
    s, R, t = horn_align(est, gt, with_scale)
    err = (s * est @ R.T + t) - gt
    return float(np.sqrt((err**2).sum(-1).mean())), s, len(ia)
