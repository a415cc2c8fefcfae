"""Trajectory export in TUM / EuRoC / KITTI formats (port of
orb_slam3_vio_fixes_tpu/io/trajectory.py, numpy only).

TUM:   "ts x y z qx qy qz qw" (ts seconds)
EuRoC: "ts_ns x y z qw qx qy qz" (nanosecond stamps)
KITTI: 3x4 row-major pose matrix per line (no timestamps)

All writers take (ts, R_cw, t_cw) tuples (camera-from-world, the internal
convention) and export camera-to-world poses.
"""

from __future__ import annotations

import numpy as np


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """(3, 3) -> (4,) float32 quaternion (x, y, z, w), Shepperd's method in
    float32 with the reference's `lie.rotmat_to_quat` arithmetic, so that
    the written files match the reference's byte for byte."""
    R = np.asarray(R, np.float32)
    m00, m01, m02 = R[0]
    m10, m11, m12 = R[1]
    m20, m21, m22 = R[2]
    trace = m00 + m11 + m22
    one, quarter, half = np.float32(1.0), np.float32(0.25), np.float32(0.5)
    tiny = np.float32(1e-12)
    if trace > 0.0:
        w = half * np.sqrt(max(one + trace, tiny))
        inv = quarter / w
        q = [(m21 - m12) * inv, (m02 - m20) * inv, (m10 - m01) * inv, w]
    elif m00 >= m11 and m00 >= m22:
        x = half * np.sqrt(max(one + m00 - m11 - m22, tiny))
        inv = quarter / x
        q = [x, (m01 + m10) * inv, (m02 + m20) * inv, (m21 - m12) * inv]
    elif m11 >= m22:
        y = half * np.sqrt(max(one - m00 + m11 - m22, tiny))
        inv = quarter / y
        q = [(m01 + m10) * inv, y, (m12 + m21) * inv, (m02 - m20) * inv]
    else:
        z = half * np.sqrt(max(one - m00 - m11 + m22, tiny))
        inv = quarter / z
        q = [(m02 + m20) * inv, (m12 + m21) * inv, z, (m10 - m01) * inv]
    q = np.asarray(q, np.float32)
    # the reference's norm is one fused multiply-add chain over (x, y, z, w)
    acc = np.float32(0.0)
    for c in q:
        acc = np.float32(np.float64(c) * np.float64(c) + np.float64(acc))
    return q / np.sqrt(acc)


def _to_wc(R_cw: np.ndarray, t_cw: np.ndarray):
    R_wc = R_cw.T
    return R_wc, -R_wc @ t_cw


def save_tum(path: str, traj):
    with open(path, "w") as f:
        for ts, R_cw, t_cw in traj:
            R_wc, C = _to_wc(np.asarray(R_cw), np.asarray(t_cw))
            q = rotmat_to_quat(R_wc)
            f.write(f"{ts:.6f} {C[0]:.7f} {C[1]:.7f} {C[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")


def save_euroc(path: str, traj):
    with open(path, "w") as f:
        for ts, R_cw, t_cw in traj:
            R_wc, C = _to_wc(np.asarray(R_cw), np.asarray(t_cw))
            q = rotmat_to_quat(R_wc)
            f.write(f"{int(ts * 1e9)} {C[0]:.7f} {C[1]:.7f} {C[2]:.7f} "
                    f"{q[3]:.7f} {q[0]:.7f} {q[1]:.7f} {q[2]:.7f}\n")


def save_kitti(path: str, traj):
    with open(path, "w") as f:
        for ts, R_cw, t_cw in traj:
            R_wc, C = _to_wc(np.asarray(R_cw), np.asarray(t_cw))
            M = np.concatenate([R_wc, C[:, None]], axis=1)
            f.write(" ".join(f"{v:.9e}" for v in M.reshape(-1)) + "\n")


def load_tum(path: str):
    """Returns (ts (N,), pos (N, 3), quat_xyzw (N, 4)); skips comment lines.
    Also reads EuRoC ground-truth CSVs (comma separated, ns stamps)."""
    ts, pos, quat = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            if len(parts) < 8:
                continue
            vals = [float(p) for p in parts[:8]]
            t = vals[0]
            if t > 1e14:  # nanoseconds
                t *= 1e-9
            ts.append(t)
            pos.append(vals[1:4])
            quat.append(vals[4:8])
    return np.asarray(ts), np.asarray(pos), np.asarray(quat)
