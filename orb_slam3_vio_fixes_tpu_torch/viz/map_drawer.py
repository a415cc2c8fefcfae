"""Map drawing: landmarks, keyframes, covisibility edges, trajectory (port of
orb_slam3_vio_fixes_tpu/viz/map_drawer.py; the MapState's tensors may live
on the card and are copied to the host here).

Reference semantics: MapDrawer (src/MapDrawer.cc:135 DrawMapPoints — black
points, red for local-map points; :178 DrawKeyFrames — blue frusta +
covisibility/spanning-tree graph lines) and the Pangolin Viewer loop.
Offline re-design: matplotlib figures written to files — the viewer is out
of the accuracy-critical path in the reference too (bUseViewer=false).
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _kf_centers(state) -> np.ndarray:
    """Camera centers C = -R_cw^T t_cw for valid keyframes."""
    R = _np(state.kf_R)
    t = _np(state.kf_t)
    valid = _np(state.kf_valid)
    C = -np.einsum("kij,kj->ki", R.transpose(0, 2, 1), t)
    return C[valid]


def covisibility_edges(state, min_shared: int = 15) -> np.ndarray:
    """(E, 2) KF index pairs sharing >= min_shared landmarks (the reference's
    covisibility-graph edge threshold, src/KeyFrame.cc:421)."""
    obs = _np(state.kf_obs)        # (K, N)
    valid = _np(state.kf_valid)
    K = obs.shape[0]
    kfs = np.where(valid)[0]
    edges = []
    sets = {k: set(obs[k][obs[k] >= 0].tolist()) for k in kfs}
    for a_i in range(len(kfs)):
        for b_i in range(a_i + 1, len(kfs)):
            a, b = kfs[a_i], kfs[b_i]
            if len(sets[a] & sets[b]) >= min_shared:
                edges.append((a, b))
    return np.array(edges, np.int32).reshape(-1, 2)


def draw_map(state, path: str, trajectory=None, min_shared: int = 15) -> dict:
    """Write a top-down (x-z) map figure: landmarks, KF centers, covisibility
    edges, and optionally the frame trajectory. Returns summary counts."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lm = _np(state.lm_pos)[_np(state.lm_valid)]
    C = _kf_centers(state)
    edges = covisibility_edges(state, min_shared)

    fig, ax = plt.subplots(figsize=(7, 7))
    if lm.size:
        ax.scatter(lm[:, 0], lm[:, 2], s=1, c="#333333", label="landmarks")
    kfs = np.where(_np(state.kf_valid))[0]
    pos = {k: None for k in kfs}
    if C.size:
        ax.scatter(C[:, 0], C[:, 2], s=24, c="#1f77b4", marker="s",
                   label="keyframes")
        for idx, k in enumerate(kfs):
            pos[k] = C[idx]
    for a, b in edges:
        if pos.get(a) is not None and pos.get(b) is not None:
            ax.plot([pos[a][0], pos[b][0]], [pos[a][2], pos[b][2]],
                    c="#2ca02c", lw=0.5, alpha=0.6)
    if trajectory:
        P = []
        for entry in trajectory:
            _, R_cw, t_cw = entry[:3]
            R_cw = _np(R_cw)
            t_cw = _np(t_cw)
            P.append(-R_cw.T @ t_cw)
        P = np.asarray(P)
        ax.plot(P[:, 0], P[:, 2], c="#d62728", lw=1.0, label="trajectory")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal", adjustable="datalim")
    ax.legend(loc="best", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return {"n_landmarks": int(lm.shape[0]), "n_keyframes": int(C.shape[0]),
            "n_covis_edges": int(edges.shape[0])}


def draw_trajectory(path: str, trajectory, gt=None) -> None:
    """x-z trajectory plot, optionally against ground truth."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    P = []
    for entry in trajectory:
        _, R_cw, t_cw = entry[:3]
        P.append(-_np(R_cw).T @ _np(t_cw))
    P = np.asarray(P)
    fig, ax = plt.subplots(figsize=(7, 5))
    if P.size:
        ax.plot(P[:, 0], P[:, 2], c="#1f77b4", label="estimate")
    if gt is not None:
        gt = np.asarray(gt)
        ax.plot(gt[:, 0], gt[:, 2], c="#999999", ls="--", label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal", adjustable="datalim")
    ax.legend(loc="best", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
