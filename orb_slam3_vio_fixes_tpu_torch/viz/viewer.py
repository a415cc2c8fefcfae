"""OfflineViewer: the Viewer thread's role, re-designed for headless runs
(port of orb_slam3_vio_fixes_tpu/viz/viewer.py).

Reference semantics: Viewer (src/Viewer.cc:162+) runs a Pangolin loop with
menu toggles and renders the map + current frame at ~30 Hz. On a headless
host the same observability is delivered offline: the viewer subscribes
to the tracker, keeps lightweight per-frame records, and renders figures /
a frame strip on demand or at shutdown.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from orb_slam3_vio_fixes_tpu_torch.viz import frame_drawer, map_drawer


class OfflineViewer:
    def __init__(self, out_dir: str, every_n: int = 10, max_frames: int = 50):
        self.out_dir = out_dir
        self.every_n = every_n
        self.max_frames = max_frames
        self.records = []
        os.makedirs(out_dir, exist_ok=True)

    def update(self, frame_idx: int, gray, uv, tracked_mask, state_name: str,
               n_kf: int, n_lm: int) -> Optional[str]:
        """Called per frame (FrameDrawer::Update analogue). Saves a rendered
        frame every `every_n` frames; returns the path when one is written."""
        self.records.append(
            {"i": frame_idx, "state": state_name, "n_kf": n_kf, "n_lm": n_lm,
             "n_feat": int(np.sum(np.asarray(tracked_mask)))
             if tracked_mask is not None else 0})
        if frame_idx % self.every_n != 0:
            return None
        if sum(1 for r in self.records if r["i"] % self.every_n == 0) > self.max_frames:
            return None
        img = frame_drawer.draw_frame(
            gray, uv, tracked_mask, state=state_name, n_kf=n_kf, n_lm=n_lm)
        path = os.path.join(self.out_dir, f"frame_{frame_idx:06d}.png")
        from PIL import Image

        Image.fromarray(np.asarray(img)).save(path)
        return path

    def finalize(self, map_state=None, trajectory=None) -> dict:
        """Render the final map + trajectory figures (Viewer shutdown)."""
        out = {"n_records": len(self.records)}
        if map_state is not None:
            out["map"] = map_drawer.draw_map(
                map_state, os.path.join(self.out_dir, "map.png"),
                trajectory=trajectory)
        if trajectory:
            map_drawer.draw_trajectory(
                os.path.join(self.out_dir, "trajectory.png"), trajectory)
            out["trajectory_png"] = True
        return out
