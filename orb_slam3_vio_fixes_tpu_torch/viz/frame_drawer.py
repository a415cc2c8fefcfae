"""Frame drawing: current image + keypoints + tracking-state banner (port of
orb_slam3_vio_fixes_tpu/viz/frame_drawer.py).

Reference semantics: FrameDrawer (src/FrameDrawer.cc:37 DrawFrame — green
squares/circles on tracked keypoints, blue for re-observed, state text bar;
:370 Update copies the tracker's per-frame vectors). Pure numpy RGB output —
no GUI dependency; callers save PNGs or feed a video writer.
"""

from __future__ import annotations

import numpy as np


def _put_marker(img: np.ndarray, u: int, v: int, color, size: int = 3) -> None:
    h, w = img.shape[:2]
    u0, u1 = max(0, u - size), min(w, u + size + 1)
    v0, v1 = max(0, v - size), min(h, v + size + 1)
    if u0 >= u1 or v0 >= v1:
        return
    # hollow square
    img[v0, u0:u1] = color
    img[v1 - 1, u0:u1] = color
    img[v0:v1, u0] = color
    img[v0:v1, u1 - 1] = color


def draw_frame(
    gray: np.ndarray,
    uv: np.ndarray,
    tracked_mask: np.ndarray | None = None,
    state: str = "OK",
    n_kf: int = 0,
    n_lm: int = 0,
) -> np.ndarray:
    """Render an RGB visualization of one tracked frame.

    gray: (H, W) float/uint8 image; uv: (N, 2) keypoint pixel coords;
    tracked_mask: which keypoints are bound to map points (drawn green,
    untracked drawn gray — the reference draws tracked-in-map green).
    Returns (H + 20, W, 3) uint8 with a footer banner like the reference's
    text bar (state, #KFs, #MPs, #matches).
    """
    g = np.clip(np.asarray(gray, np.float32), 0, 255).astype(np.uint8)
    h, w = g.shape
    img = np.stack([g, g, g], axis=-1)
    uv = np.asarray(uv)
    if tracked_mask is None:
        tracked_mask = np.zeros(len(uv), dtype=bool)
    n_tracked = 0
    for i in range(len(uv)):
        u, v = int(round(float(uv[i, 0]))), int(round(float(uv[i, 1])))
        if not (0 <= u < w and 0 <= v < h):
            continue
        if tracked_mask[i]:
            _put_marker(img, u, v, (0, 255, 0))
            n_tracked += 1
        else:
            _put_marker(img, u, v, (160, 160, 160), size=2)

    # footer banner: dark bar with a green fill proportional to matches
    banner = np.zeros((20, w, 3), np.uint8)
    banner[:, :, :] = 30
    frac = min(1.0, n_tracked / 200.0)
    banner[6:14, : int(frac * w), 1] = 180
    out = np.concatenate([img, banner], axis=0)
    out.setflags(write=False)
    # attach status for callers/tests (numpy arrays can't hold text cleanly)
    draw_frame.last_status = {
        "state": state, "n_kf": n_kf, "n_lm": n_lm, "n_tracked": n_tracked,
    }
    return out
