"""Monocular tracking: the two-view initialisation and the monocular
keyframe rule (port of orb_slam3_vio_fixes_tpu/frontend/mono_tracking.py).

Mono frames carry no depth (ur = depth = -1), so a keyframe spawns no stereo
landmarks and the map grows only by triangulation across keyframes. The
map starts from two frames: windowed matching (`search_for_initialization`,
through kernel K2), F/H RANSAC (`ops/twoview.py`), the two keyframes and
their landmarks scaled to a unit median depth (`create_initial_mono_map`),
then a BA over the pair. `MonoInit` carries that state machine and the
keyframe rule for both monocular trackers; the monocular-inertial one is in
inertial_tracking.py.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam3_vio_fixes_tpu_torch.frontend import tracking as trk
from orb_slam3_vio_fixes_tpu_torch.frontend.frame import FrameData, build_mono_frame
from orb_slam3_vio_fixes_tpu_torch.ops import image as image_ops
from orb_slam3_vio_fixes_tpu_torch.ops import matching, twoview
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera


def search_for_initialization(ref: FrameData, cur: FrameData, window: float):
    """Windowed descriptor matching between the initialisation reference
    frame and the current frame: radius `window` px, octaves within +-1,
    ratio 0.9 against any second best, rotation consistency. Returns (idx
    (N,) int32 ref feature -> cur feature or -1, the match count)."""
    radius = torch.full((ref.uv.shape[0],), float(window), dtype=torch.float32,
                        device=ref.uv.device)
    res = matching.search_by_projection(
        ref.uv, ref.valid, ref.desc, ref.octave, radius,
        cur.uv, cur.valid, cur.desc, cur.octave,
        max_dist=matching.TH_LOW, ratio=0.9, apply_ratio_same_octave=False)
    ok = matching.rotation_consistency(ref.angle, cur.angle, res.idx, res.idx >= 0)
    return torch.where(ok, res.idx, torch.full_like(res.idx, -1)), ok.sum()


def create_initial_mono_map(state: ms.MapState, ref: FrameData, cur: FrameData, idx,
                            R21, t21, points, good, cfg: trk.TrackerConfig):
    """The initial two-keyframe map, in place: points (N, 3) triangulated in
    the reference camera (= world) and the translation scaled by the
    inverse median depth of the good points (the mean of the two middle
    values on an even count, as jnp.nanmedian), every good match a
    landmark seen by both keyframes. Returns (state, n_landmarks, obs of
    keyframe 1, R21, scaled t21)."""
    N = ref.uv.shape[0]
    L = state.lm_pos.shape[0]
    dev = ref.uv.device
    med = matching.nanmedian(torch.where(good, points[:, 2],
                                         torch.full_like(points[:, 2], float("nan"))))
    inv_med = 1.0 / torch.clamp(torch.nan_to_num(med, nan=1.0), min=1e-6)
    Xw = points * inv_med
    t1 = t21 * inv_med

    is_new = good & (idx >= 0)
    slot_off = torch.cumsum(is_new.to(torch.int64), 0) - 1
    is_new &= slot_off < L - 1
    slots = torch.where(is_new, slot_off, torch.full_like(slot_off, L - 1))

    dist = torch.linalg.norm(Xw, dim=-1)       # camera 0 sits at the origin
    normal = Xw / torch.clamp(dist[:, None], min=1e-9)
    sf = image_ops.scale_factors(cfg.orb.n_levels, cfg.orb.scale, device=dev)
    maxdist = dist * sf[ref.octave.to(torch.int64).clamp(0, cfg.orb.n_levels - 1)]
    state = ms.add_landmarks(state, slots, Xw, ref.desc, normal, maxdist / sf[-1], maxdist,
                             0, is_new)
    neg = torch.full((N,), -1, dtype=torch.int32, device=dev)
    slots32 = slots.to(torch.int32)
    zero3 = torch.zeros(3, device=dev)
    state = ms.insert_keyframe(state, 0, torch.eye(3, device=dev), zero3, ref.ts, zero3,
                               zero3, zero3, -1, ref.uv, ref.ur, ref.octave, ref.angle,
                               ref.desc, ref.valid, torch.where(is_new, slots32, neg),
                               ref.depth)
    # the same landmarks on the matched current-frame features (one winner
    # per current feature, so the scatter has no duplicates)
    obs1 = ms.set_masked(neg, idx.to(torch.int64).clamp(0, N - 1), is_new, slots32)
    state = ms.insert_keyframe(state, 1, R21, t1, cur.ts, zero3, zero3, zero3, 0, cur.uv,
                               cur.ur, cur.octave, cur.angle, cur.desc, cur.valid, obs1,
                               cur.depth)
    state = ms.update_landmark_stats(state, cfg.orb.n_levels, cfg.orb.scale)
    return state, is_new.sum(), obs1, R21, t1


class MonoInit:
    """The two-frame initialisation state machine and the monocular
    keyframe rule, mixed into a StereoTracker subclass (bf = 0)."""

    def _mono_setup(self, init_window: float):
        self.init_window = init_window
        self.ref_frame = None           # the initialisation reference FrameData
        self.gen = torch.Generator(device=self.device).manual_seed(0)

    def _spawn_new_map(self):
        super()._spawn_new_map()
        self.ref_frame = None

    def _initialize(self, frame: FrameData) -> bool:
        """A frame with >= 100 features becomes the reference; a later one
        with >= 100 matches to it is reconstructed against it. On success
        both become keyframes 0 and 1, a BA over the pair follows, and the
        pair enters the place-recognition database."""
        n_feat = int(frame.valid.sum())
        if self.ref_frame is None:
            if n_feat >= 100:
                self.ref_frame = frame
            return False
        if n_feat < 100:
            self.ref_frame = None       # the reference is too stale: restart
            return False
        idx, n_m = search_for_initialization(self.ref_frame, frame, self.init_window)
        if int(n_m) < 100:
            self.ref_frame = frame
            return False
        N = frame.uv.shape[0]
        res = twoview.reconstruct(self.gen, self.ref_frame.uv,
                                  frame.uv[idx.to(torch.int64).clamp(0, N - 1)], idx >= 0,
                                  self.cam)
        if not bool(res.success):
            return False
        self.state, n_lm, _, _, _ = create_initial_mono_map(
            self.state, self.ref_frame, frame, idx, res.R, res.t, res.points, res.good,
            self.cfg)
        self.n_kf = 2
        self.kf_order = [0, 1]
        self.n_lm = int(n_lm)
        # BA over the pair, keyframe 0 fixed
        cfg = self.cfg
        adj = torch.as_tensor(np.r_[1, np.full(cfg.ba_window - 1, -1)], device=self.device)
        fixed = torch.as_tensor(np.r_[0, np.full(cfg.ba_anchors - 1, -1)], device=self.device)
        self.state, _ = trk.local_ba_impl(self.state, adj, fixed, self.cam, self.bf, cfg)
        self._set_frame(frame, self.state.kf_R[1].clone(), self.state.kf_t[1].clone(),
                        self.state.kf_obs[1].clone())
        self.track_state = trk.TrackState.OK
        self.frames_since_kf = 0
        self.ref_inliers = self.n_lm
        self.ref_frame = None
        self._refresh_ref_pose(1)
        if self.loop_closer is not None:
            self.loop_closer.add_keyframe(self.state, 0)
            self.loop_closer.add_keyframe(self.state, 1)
        return True

    def _need_keyframe(self, n_inliers: int) -> bool:
        """Max frames (c1a) or the inlier ratio at 0.9 (c2); no close-point
        condition (no depth)."""
        cfg = self.cfg
        if self.track_state != trk.TrackState.OK:
            return False
        c1a = self.frames_since_kf >= cfg.max_frames_between_kf
        c2 = n_inliers < cfg.kf_inlier_ratio * self.ref_inliers and n_inliers > 15
        return bool(c1a or c2)


def mono_config(cfg: trk.TrackerConfig) -> trk.TrackerConfig:
    """The monocular trackers' inlier ratio (0.9) and at least 6 BA
    iterations."""
    return cfg._replace(kf_inlier_ratio=0.9, ba_iters=max(cfg.ba_iters, 6))


class MonocularTracker(MonoInit, trk.StereoTracker):
    """Monocular SLAM (MONOCULAR sensor mode), sync mode: the two-view
    initialisation in place of the stereo bootstrap, bf = 0, the motion
    model's search radii (15, 30) px."""

    def __init__(self, cam: Camera, cfg: trk.TrackerConfig = trk.TrackerConfig(), *, device,
                 loop_closer=None, relocalizer=None, atlas=None, init_window: float = 100.0):
        super().__init__(cam, 0.0, mono_config(cfg), device=device, loop_closer=loop_closer,
                         relocalizer=relocalizer, atlas=atlas)
        self._mono_setup(init_window)
        self.match_radius = (15.0, 30.0)

    def process_mono(self, img, ts: float):
        frame = build_mono_frame(self._upload_image(img), self._ts(ts), self.cfg.orb)
        return self.process_frame(frame, ts)
