"""Stereo-inertial tracking: IMU preintegration, IMU initialisation, joint
visual-inertial optimisation (port of the stereo part of
orb_slam3_vio_fixes_tpu/frontend/inertial_tracking.py).

`StereoInertialTracker` extends the visual `StereoTracker` (sync mode) and
reuses its device functions unchanged; it adds
  * vi_motion_opt: a 2-state (previous frame, current frame) joint
    visual-inertial pose optimisation, the previous state held by a
    marginal prior;
  * vi_track_step: the post-init per-frame path (preintegration, IMU
    prediction, motion-model matching, two joint optimisations around the
    local-map search) with one packed pull;
  * inertial_local_ba: temporal-window VI bundle adjustment over the last W
    keyframes with compacted window landmarks;
  * on the host: the 3-stage IMU initialisation (gravity bootstrap,
    inertial-only optimisation, map gravity alignment), then the window BA
    and the full-map VI BA.

With a `LoopCloser`, a `Relocalizer` and an `Atlas` it also places itself
in its maps: a relocalisation inside the dead-reckoning window, a new map
in the Atlas when the window runs out, loop detection once the IMU is
initialised (the inertial closer's 4-DoF graph, then the full-map VI BA),
and the MergeInertialBA analogue after a map merge. `process_rgbd_inertial`
is the IMU_RGBD entry; `MonoInertialTracker` the IMU_MONOCULAR one. When
the loop closer carries a `parallel.Mesh`, the full-map VI BA runs
landmark-sharded over it (optim/vi_global_ba.run_global_vi_ba_sharded).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam3_vio_fixes_tpu_torch.frontend import tracking as trk
from orb_slam3_vio_fixes_tpu_torch.frontend.frame import build_mono_frame
from orb_slam3_vio_fixes_tpu_torch.frontend.mono_tracking import MonoInit, mono_config
from orb_slam3_vio_fixes_tpu_torch.imu import preintegration as pre
from orb_slam3_vio_fixes_tpu_torch.optim import inertial_init as ii
from orb_slam3_vio_fixes_tpu_torch.optim import vi_ba
from orb_slam3_vio_fixes_tpu_torch.optim import vi_global_ba as vg
from orb_slam3_vio_fixes_tpu_torch.runtime import tracing
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms
from orb_slam3_vio_fixes_tpu_torch.utils import lie
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera
from orb_slam3_vio_fixes_tpu_torch.utils.linalg import compact_indices

# MapState stores camera poses T_cw; VI states are body-in-world (R_wb, p_wb)
# (see optim/vi_ba.py), both batched over leading dimensions.
body_from_cam = vi_ba.body_from_cam
cam_from_body = vi_ba.cam_from_body


# Seconds of IMU data after the initialisation before the map's gravity
# direction is trusted over a merge's roll and pitch (the reference's first
# inertial BA refinement, VIBA1, runs 5 s after the initialisation).
GRAVITY_SETTLE_S = 5.0


class InertialConfig(NamedTuple):
    frame_samples: int = 32     # capacity of a frame's IMU window (samples)
    kf_samples: int = 512       # capacity of a keyframe pair's window
    init_min_kfs: int = 5
    init_min_time: float = 0.95
    vi_window: int = 8
    max_local_lm: int = 2048
    fix_scale: bool = True
    # IMU dead-reckoning budget while RECENTLY_LOST and the speed that marks
    # a diverged IMU state (forces an active-map reset)
    recently_lost_time: float = 5.0
    max_speed: float = 25.0


def pack_imu(windows, capacity: int, count: bool = True) -> np.ndarray:
    """(P, S, 7) float32 block of P host sample windows (rows [acc (3),
    gyro (3), dt], front-packed; None for no window), each cut to `capacity`
    rows, the rest zero. S is the longest window's real length, 1 + the
    index of its last row with dt != 0 (not the count of such rows), at
    least 1. A row with dt = 0 is an exact identity step of
    `pre.integrate`, so the rows past S change nothing, and integrate takes
    one step per row that exists. With `count`, S goes to the counter
    imu.rows_integrated and capacity - S to imu.rows_skipped."""
    ws = [None if w is None else np.asarray(w, np.float32).reshape(-1, 7)[:capacity]
          for w in windows]
    S = 1
    for w in ws:
        if w is not None:
            real = np.flatnonzero(w[:, 6] != 0)
            if real.size:
                S = max(S, int(real[-1]) + 1)
    out = np.zeros((len(ws), S, 7), np.float32)
    for i, w in enumerate(ws):
        if w is not None:
            out[i, :min(len(w), S)] = w[:S]
    if count:
        tracing.count("imu.rows_integrated", S)
        tracing.count("imu.rows_skipped", capacity - S)
    return out


class BodyState(NamedTuple):
    R_wb: torch.Tensor
    p_wb: torch.Tensor
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor


def _stack_states(a: BodyState, b: BodyState, dev) -> vi_ba.VIStates:
    return vi_ba.VIStates(*(torch.stack([x, y]) for x, y in zip(a, b)),
                          fixed=torch.zeros(2, dtype=torch.bool, device=dev),
                          valid=torch.ones(2, dtype=torch.bool, device=dev))


def vi_motion_opt(state: ms.MapState, prev: BodyState, prior_H, cur: BodyState,
                  pre_frame: pre.Preintegrated, frame, cur_obs, cam: Camera, bf: float,
                  calib: pre.ImuCalib, cfg: trk.TrackerConfig, n_rounds: int = 2,
                  n_iters: int = 5, want_prior: bool = True):
    """Joint visual-inertial motion-only optimisation of the current frame:
    two 15-DoF states, reprojection factors on the current one, one inertial
    factor, the 15-DoF prior on the previous one; the previous state is then
    marginalised into the next frame's prior (None unless `want_prior`).
    Returns (cur', cur_obs', n_inliers, next_prior_H)."""
    N = frame.uv.shape[0]
    L = state.lm_pos.shape[0]
    dev = frame.uv.device
    ids = cur_obs.to(torch.int64).clamp(0, L - 1)
    act = (cur_obs >= 0) & state.lm_valid[ids] & frame.valid
    inv_s2 = trk.octave_inv_sigma2(cfg.orb, dev)[
        frame.octave.to(torch.int64).clamp(0, cfg.orb.n_levels - 1)]
    reproj = vi_ba.VIReprojFactors(
        state_idx=torch.ones(N, dtype=torch.int64, device=dev),
        lm_idx=torch.arange(N, device=dev),
        uvr=torch.cat([frame.uv, frame.ur[:, None]], -1), inv_sigma2=inv_s2, valid=act)
    inertial = vi_ba.VIInertialFactors.from_preintegrations(
        torch.zeros(1, dtype=torch.int64, device=dev),
        torch.ones(1, dtype=torch.int64, device=dev),
        pre.Preintegrated(*(x[None] for x in pre_frame)),
        torch.ones(1, dtype=torch.bool, device=dev))
    prior = vi_ba.VIPrior(0, *prev, H=prior_H, valid=True)
    R_cb, t_cb = calib.cam_from_body()
    prob = vi_ba.VIProblem(
        states=_stack_states(prev, cur, dev), lm=state.lm_pos[ids], lm_valid=act,
        lm_fixed=torch.ones(N, dtype=torch.bool, device=dev), reproj=reproj,
        inertial=inertial, prior=prior, cam=cam, bf=bf, R_cb=R_cb, t_cb=t_cb)
    out, inlier, H = vi_ba.solve_vi_ba(
        prob, vi_ba.VIBAConfig(n_rounds=n_rounds, n_iters=n_iters), want_info=want_prior)
    st = out.states
    new_obs = torch.where(inlier | ~act, cur_obs, torch.full_like(cur_obs, -1))
    n_inl = (inlier & act).sum()
    next_H = (vi_ba.marginalize(H, slice(15, 30), slice(0, 15)) if want_prior
              else None)
    return BodyState(*(x[1] for x in st[:5])), new_obs, n_inl, next_H


def vi_track_step(state: ms.MapState, prev_obs, prev_octave, prev_angle,
                  body: BodyState, prior_H, imu_window, frame, window_kfs,
                  cam: Camera, bf: float, calib: pre.ImuCalib, th_narrow: float,
                  th_wide: float, th_local: float, cfg: trk.TrackerConfig):
    """The post-init visual-inertial OK path: preintegration, IMU state
    prediction, motion-model matching (retried with the wide radius when
    < 20 matches: a host branch on one synced count, where the reference used
    lax.cond), a first joint optimisation (1 round of 4 iterations, enough to
    place the local-map search windows), the local-map search, the second
    joint optimisation with the full gating schedule, and the decision
    statistics.

    Returns (cur_body, next_H, cur_obs, cur_pred, R_pred, t_pred, R2, t2,
    packed) with packed = [R2 (9), t2 (3), n_m, n_inl2, close tracked,
    close untracked, v (3)]."""
    with tracing.span("vi_track_step.preintegrate"):
        pre_frame = pre.integrate(imu_window, body.bg, body.ba, calib)
        R2p, p2p, v2p = pre.predict_state(body.R_wb, body.p_wb, body.v, body.bg, body.ba,
                                          pre_frame)
    cur_pred = BodyState(R2p, p2p, v2p, body.bg, body.ba)
    R_cb, t_cb = calib.cam_from_body()
    R_pred, t_pred = cam_from_body(R2p, p2p, R_cb, t_cb)
    with tracing.span("vi_track_step.match"):
        cur_obs, n_m = trk.match_previous(state, prev_obs, prev_octave, prev_angle, R_pred,
                                          t_pred, frame, cam, bf, th_narrow, cfg)
        if trk.retry_wide(n_m):
            cur_obs, n_m = trk.match_previous(state, prev_obs, prev_octave, prev_angle,
                                              R_pred, t_pred, frame, cam, bf, th_wide, cfg)
    with tracing.span("vi_track_step.opt"):
        cur_body, cur_obs, _, _ = vi_motion_opt(
            state, body, prior_H, cur_pred, pre_frame, frame, cur_obs, cam, bf, calib, cfg,
            n_rounds=1, n_iters=4, want_prior=False)
    R1, t1 = cam_from_body(cur_body.R_wb, cur_body.p_wb, R_cb, t_cb)
    # search only: the joint optimisation below re-optimises the pose
    with tracing.span("vi_track_step.local_map_search"):
        cur_obs = trk.local_map_search(state, R1, t1, frame, cur_obs, window_kfs, cam, bf,
                                       th_local, cfg)
    with tracing.span("vi_track_step.opt"):
        cur_body, cur_obs, n_inl2, next_H = vi_motion_opt(
            state, body, prior_H, cur_body, pre_frame, frame, cur_obs, cam, bf, calib, cfg,
            n_rounds=2, n_iters=5)
    R2, t2 = cam_from_body(cur_body.R_wb, cur_body.p_wb, R_cb, t_cb)
    packed = torch.cat([trk._packed(R2, t2, n_m, n_inl2, frame, cur_obs, cam, bf, cfg),
                        cur_body.v])
    return cur_body, next_H, cur_obs, cur_pred, R_pred, t_pred, R2, t2, packed


def single_view_landmarks(reproj: vi_ba.VIReprojFactors, n_lm: int,
                          n_states: int) -> torch.Tensor:
    """(n_lm,) bool: the window landmarks whose valid reprojection factors
    all come from one window state and include no stereo row. Their 3x3
    block has rank 2 (one bearing, no disparity): the float32 LM damping
    cannot make it invertible, and an inverse that stays finite sends such
    a landmark along its ray without bound (ORB-SLAM3 optimises only the
    landmarks the window constrains). On the device, no host sync; every
    pad goes to a dump row of its own."""
    dev = reproj.valid.device
    valid = reproj.valid
    lm = reproj.lm_idx.to(torch.int64)
    pair = lm * n_states + reproj.state_idx.to(torch.int64)
    seen = ms.set_masked(torch.zeros(n_lm * n_states, dtype=torch.bool, device=dev),
                         pair, valid, True).reshape(n_lm, n_states)
    stereo = ms.set_masked(torch.zeros(n_lm, dtype=torch.bool, device=dev), lm,
                           valid & (reproj.uvr[:, 2] >= 0.0), True)
    return (seen.sum(1) == 1) & ~stereo


def inertial_local_ba(state: ms.MapState, window_kfs, kf_imu, kf_imu_valid,
                      cam: Camera, bf: float, calib: pre.ImuCalib,
                      cfg: trk.TrackerConfig, icfg: InertialConfig,
                      hold_single_view: bool = False) -> ms.MapState:
    """Temporal-window VI bundle adjustment: the last W keyframes
    (`window_kfs`, newest first, -1 padded) and their landmarks, the IMU
    chain between consecutive window keyframes (kf_imu[i], (W-1, S, 7),
    joins window_kfs[i+1] -> [i]), the oldest state fixed. Window landmarks
    are compacted to icfg.max_local_lm; those seen by one observer in the map
    are held, and with `hold_single_view` also those the window sees from
    one keyframe's monocular rows only (`single_view_landmarks`). Updates
    `state` in place."""
    K, N = state.kf_obs.shape
    L = state.lm_pos.shape[0]
    W = window_kfs.shape[0]
    dev = window_kfs.device
    safe = window_kfs.clamp(0, K - 1)
    ok = (window_kfs >= 0) & state.kf_valid[safe]
    R_cb, t_cb = calib.cam_from_body()
    R_wb, p_wb = body_from_cam(state.kf_R[safe], state.kf_t[safe], R_cb, t_cb)
    ar = torch.arange(W, device=dev)
    oldest = torch.where(ok, ar, torch.full_like(ar, -1)).max()
    fixed = (ar == oldest) | ~ok
    states = vi_ba.VIStates(R_wb, p_wb, state.kf_vel[safe], state.kf_bg[safe],
                            state.kf_ba[safe], fixed=fixed, valid=ok)

    obs_rows = torch.where(ok[:, None], state.kf_obs[safe],
                           torch.full((), -1, dtype=torch.int32, device=dev))
    flat = obs_rows.reshape(-1).to(torch.int64)
    cand_mask = ms.set_masked(torch.zeros(L, dtype=torch.bool, device=dev),
                              flat.clamp(0, L - 1), flat >= 0, True) & state.lm_valid
    M = icfg.max_local_lm
    cand_idx, filled = compact_indices(cand_mask, M)
    cand_ok = cand_mask[cand_idx] & filled
    inv = ms.set_masked(torch.full((L,), -1, dtype=torch.int64, device=dev), cand_idx,
                        cand_ok, torch.arange(M, device=dev))
    lm_loc = inv[flat.clamp(0, L - 1)]
    f_valid = (flat >= 0) & (lm_loc >= 0) & state.kf_feat_valid[safe].reshape(-1)
    inv_s2 = trk.octave_inv_sigma2(cfg.orb, dev)[
        state.kf_octave[safe].to(torch.int64).clamp(0, cfg.orb.n_levels - 1)]
    reproj = vi_ba.VIReprojFactors(
        state_idx=ar.repeat_interleave(N), lm_idx=lm_loc.clamp(0, M - 1),
        uvr=torch.cat([state.kf_uv[safe], state.kf_ur[safe][..., None]], -1).reshape(-1, 3),
        inv_sigma2=inv_s2.reshape(-1), valid=f_valid)
    # factor i joins state i+1 (older) -> state i, at the older one's bias
    pres = pre.integrate(kf_imu, state.kf_bg[safe][1:], state.kf_ba[safe][1:], calib)
    inertial = vi_ba.VIInertialFactors.from_preintegrations(
        ar[1:], ar[:-1], pres, kf_imu_valid & ok[1:] & ok[:-1])
    # single-observer landmarks stay at their stereo anchor
    n_obs = ms.landmark_obs_count(state)[cand_idx]
    held = (n_obs < 2) | ~cand_ok
    if hold_single_view:
        held = held | single_view_landmarks(reproj, M, W)
    prob = vi_ba.VIProblem(
        states=states, lm=state.lm_pos[cand_idx], lm_valid=cand_ok,
        lm_fixed=held, reproj=reproj, inertial=inertial,
        prior=vi_ba.VIPrior.none(dev), cam=cam, bf=bf, R_cb=R_cb, t_cb=t_cb)
    out, inlier, _ = vi_ba.solve_vi_ba(prob, vi_ba.VIBAConfig(n_rounds=2, n_iters=6),
                                       want_info=False)
    st = out.states
    R_cw, t_cw = cam_from_body(st.R_wb, st.p_wb, R_cb, t_cb)
    upd = ok & ~fixed
    state.kf_R.copy_(ms.set_masked(state.kf_R, safe, upd, R_cw))
    state.kf_t.copy_(ms.set_masked(state.kf_t, safe, upd, t_cw))
    state.kf_vel.copy_(ms.set_masked(state.kf_vel, safe, ok, st.v))
    state.kf_bg.copy_(ms.set_masked(state.kf_bg, safe, ok, st.bg))
    state.kf_ba.copy_(ms.set_masked(state.kf_ba, safe, ok, st.ba))
    state.lm_pos.copy_(ms.set_masked(state.lm_pos, cand_idx, cand_ok, out.lm))
    # unbind the window keyframes' outlier observations
    drop = (f_valid & ~inlier).reshape(W, N)
    rows = state.kf_obs[safe]
    state.kf_obs.copy_(ms.set_masked(state.kf_obs, safe, ok,
                                     torch.where(drop, torch.full_like(rows, -1), rows)))
    return state._replace(epoch=state.epoch + 1)


class StereoInertialTracker(trk.StereoTracker):
    """Stereo-inertial SLAM front end (IMU_STEREO sensor mode), sync mode.

    Host additions over the visual tracker: IMU buffers between frames and
    keyframes, the 3-stage IMU initialisation, the marginalised-prior joint
    motion optimisation after init, and inertial window BA for mapping.

    The initialisation's window VI BA holds the landmarks the window sees
    from one keyframe's monocular rows only (`hold_single_view_at_init`):
    their rank-2 blocks sent them along their rays without bound. The later
    window BAs leave them free: holding them there too moved the stereo-
    inertial loop (chip_smoke phase 12) to an ATE over its bar."""

    hold_single_view_at_init = True

    def __init__(self, cam: Camera, bf: float, calib: pre.ImuCalib,
                 cfg: trk.TrackerConfig = trk.TrackerConfig(),
                 icfg: InertialConfig = InertialConfig(), *, device,
                 loop_closer=None, relocalizer=None, atlas=None, rig=None):
        super().__init__(cam, bf, cfg, device=device, loop_closer=loop_closer,
                         relocalizer=relocalizer, atlas=atlas, rig=rig)
        self.calib = calib
        self.icfg = icfg
        self.imu_ready = False
        self.body = None            # BodyState of the last frame
        self.prior_H = torch.eye(15, device=self.device) * 1e6
        self._lost_since = None     # RECENTLY_LOST entry timestamp
        self.kf_imu_buf = []        # samples since the last keyframe (host rows)
        self.kf_windows = {}        # kf_id -> (S, 7) host window from the previous KF
        self.t_first_kf = None
        self.t_imu_init = None      # timestamp of the IMU initialisation's keyframe
        self.n_vi_ba = 0
        self.velocity_log = []
        self._pose_dev = None       # pose of the last packed-path frame

    # -- inertial keyframe culling: splice the temporal chain and merge the
    # two adjoining preintegration windows --

    def _can_cull(self) -> bool:
        # the IMU initialisation consumes the dense pre-init chain; culling
        # starts once the map is gravity-aligned
        return self.imu_ready

    def _loop_enabled(self) -> bool:
        # no place recognition on a pre-init (non-metric, gravity-unaligned)
        # inertial map
        return self.imu_ready

    def _gravity_aligned(self) -> bool:
        """The map's roll and pitch can be trusted over a merge's Sim3 once its
        IMU has had GRAVITY_SETTLE_S of data since the initialisation (the
        reference forces yaw-only merges after its first inertial BA
        refinement, which runs 5 s after the IMU initialisation): right
        after a short initialisation the map's gravity can be degrees off
        (4.6 and 6.6 degrees for the two maps of chip_smoke.py's phase 13,
        11 degrees apart, which a yaw-only merge would keep)."""
        if not self.imu_ready or self.t_imu_init is None:
            return False
        t_kf = float(self.state.kf_ts[self.kf_order[-1]])
        return t_kf - self.t_imu_init >= GRAVITY_SETTLE_S

    def _search_mult(self, track_state, frames_since_reloc: int) -> float:
        """The healthy states search at 1.0 whatever the base (RGB-D sets
        1.5): widening there admits wrong matches into the joint solves.
        Only the degraded states (recently lost, just relocalised) widen."""
        base = super()._search_mult(track_state, frames_since_reloc)
        return base if base > 1.5 else 1.0

    def _next_live(self, k):
        pos = self.kf_order.index(k)
        return self.kf_order[pos + 1] if pos + 1 < len(self.kf_order) else -1

    def _filter_culls(self, cull):
        """Veto culls whose merged IMU window would overflow the fixed sample
        capacity, and the newest keyframe (its window is still filling)."""
        keep = []
        for k in cull:
            s = self._next_live(k)
            if s < 0:
                continue
            n = sum(int((w[:, 6] > 0).sum()) for w in
                    (self.kf_windows.get(k), self.kf_windows.get(s)) if w is not None)
            if n <= self.icfg.kf_samples:
                keep.append(k)
        return keep

    def _on_culled(self, cull):
        """Merge each culled keyframe's IMU window into its successor's, so
        the successor's preintegration spans from the culled keyframe's
        predecessor (the excise splice of kf_prev)."""
        for k in cull:
            s = self._next_live(k)
            wk = self.kf_windows.pop(k, None)
            if s < 0 or wk is None:
                continue
            rows = [wk[wk[:, 6] > 0]]
            ws = self.kf_windows.get(s)
            if ws is not None:
                rows.append(ws[ws[:, 6] > 0])
            self.kf_windows[s] = self._pad_kf_imu(np.concatenate(rows))

    # -- helpers --

    def _pad_kf_imu(self, samples) -> np.ndarray:
        """The (S, 7) window a keyframe keeps: its real rows, at most
        kf_samples."""
        return pack_imu([samples], self.icfg.kf_samples, count=False)[0]

    def _body_of(self, R_cw, t_cw, v, bg, ba) -> BodyState:
        R_wb, p_wb = body_from_cam(R_cw, t_cw, *self.calib.cam_from_body())
        return BodyState(R_wb, p_wb, v, bg, ba)

    def _kf_body(self, k: int) -> BodyState:
        """Body state of keyframe slot k (clones: the map changes in place)."""
        st = self.state
        return self._body_of(st.kf_R[k].clone(), st.kf_t[k].clone(),
                             st.kf_vel[k].clone(), st.kf_bg[k].clone(),
                             st.kf_ba[k].clone())

    def _pose_out(self):
        return self._pose_host() + (self.track_state,)

    # -- per-frame entry points --

    def process_stereo_inertial(self, img_l, img_r, ts: float, imu_np):
        """imu_np: (n, 7) float32 [acc (3), gyro (3), dt] samples since the
        previous frame."""
        return self._track_inertial(self._build_stereo(img_l, img_r, ts), ts, imu_np)

    def process_rgbd_inertial(self, img, depth, ts: float, imu_np):
        """IMU_RGBD entry: the depth-derived right coordinates feed the same
        visual-inertial loop."""
        return self._track_inertial(self._build_rgbd(img, depth, ts), ts, imu_np)

    def _track_inertial(self, frame, ts: float, imu_np):
        cfg = self.cfg
        imu_np = np.asarray(imu_np, np.float32).reshape(-1, 7)
        # the last frame's pose, kept only when it went through the packed
        # path (the velocity model needs no device pull then)
        prev_pose, self._pose_dev = self._pose_dev, None
        self.kf_imu_buf.extend(list(imu_np))
        if self.track_state == trk.TrackState.NOT_INITIALIZED:
            # keep buffering IMU across a (possibly multi-frame) visual init
            if self._initialize(frame):
                self.t_first_kf = ts
                self.kf_imu_buf = []
                z = torch.zeros(3, device=self.device)
                self.body = self._body_of(self.R, self.t, z, z, z)
            self._record(ts)
            return self._pose_out()
        if self.body is None:
            # a loaded map (SLAMSystem.load_atlas) carries no IMU state:
            # relocalise into it; its IMU initialises anew from there
            out = self._recover(frame, ts)
            if self.track_state == trk.TrackState.OK:
                z = torch.zeros(3, device=self.device)
                self.body = self._body_of(self.R, self.t, z, z, z)
            return out
        self.frames_since_reloc += 1
        if (self.track_state == trk.TrackState.RECENTLY_LOST
                and self.relocalizer is not None):
            # visual relocalisation inside the dead-reckoning window
            hit = self.relocalizer.relocalize(self.state, frame, self.cam, self.bf, cfg)
            if hit is not None:
                R, t, cur_obs, n_inl = hit
                self.track_state = trk.TrackState.OK
                self._lost_since = None
                self.lost_frames = 0
                self.frames_since_reloc = 0
                self.vel = None
                self.last_n_inliers = n_inl
                # keep the dead-reckoned velocity and biases; the pose jumped,
                # so the marginal prior's linearisation point is void
                self.body = self._body_of(R, t, *self.body[2:])
                self.prior_H = torch.eye(15, device=self.device) * 1e2
                self._set_frame(frame, R, t, cur_obs)
                self._record(ts)
                return self._pose_out()
        window = self._local_window()
        th_n, th_w = self.match_radius
        th_l = self._local_search_th()
        cur_pred = vel_step = None
        if self.imu_ready:
            with tracing.span("vi_track_step"):
                (cur_body, next_H, cur_obs, cur_pred, R_pred, t_pred, R2, t2,
                 packed) = vi_track_step(
                    self.state, self.prev_obs, self.prev_octave, self.prev_angle,
                    self.body, self.prior_H,
                    self._upload(pack_imu([imu_np], self.icfg.frame_samples)[0]), frame,
                    window, self.cam, self.bf, self.calib, th_n, th_w, th_l, cfg)
            with tracing.span("track.pull.wait"):
                packed_np = packed.cpu().numpy()    # the one pull
            self.body = cur_body
            self.prior_H = next_H
            self.velocity_log.append(packed_np[16:19])
        else:
            # pre-init: the visual tracker's per-frame path
            has_vel = self.vel is not None
            dRv, dtv = self.vel if has_vel else (None, None)
            with tracing.span("track_step"):
                R2, t2, cur_obs, packed, R_pred, t_pred, *vel_step = trk.track_step_impl(
                    self.state, self.prev_obs, self.prev_octave, self.prev_angle,
                    self.R, self.t, dRv, dtv, frame, window, self.cam, self.bf,
                    th_n, th_w, th_l, cfg, has_vel=has_vel)
            with tracing.span("track.pull.wait"):
                packed_np = packed.cpu().numpy()
            # the body-state shadow the IMU initialisation starts from
            self.body = self._body_of(R2, t2, *self.body[2:])
        self._frame_stats = packed_np[12:16].astype(np.int64)
        n_inl2 = int(packed_np[13])
        self.last_n_inliers = n_inl2
        if n_inl2 < cfg.min_kf_inliers and self.ref_kf >= 0:
            # reference-keyframe fallback (windowless descriptor matching),
            # accepted only on a decisive win: a marginal fallback pose
            # rebases the body state off the IMU-consistent track
            with tracing.span("track_ref_kf"):
                R2f, t2f, obs_f, packed_f = trk.track_reference_kf(
                    self.state, self.ref_kf, R_pred, t_pred, frame, window, self.cam,
                    self.bf, th_l, cfg)
                with tracing.span("track_ref_kf.wait"):
                    n_f = int(packed_f[13].cpu())
            if n_f >= max(cfg.min_kf_inliers, 3 * max(n_inl2, 1)):
                R2, t2, cur_obs = R2f, t2f, obs_f
                packed_np = None
                n_inl2 = self.last_n_inliers = n_f
                self.body = self._body_of(R2, t2, *self.body[2:])
                if self.imu_ready:
                    # the pose left the marginal prior's linearisation point
                    self.prior_H = torch.eye(15, device=self.device) * 1e2
        if n_inl2 < cfg.min_kf_inliers:
            return self._handle_lost(frame, ts, R_pred, t_pred, cur_obs, cur_pred)

        self._lost_since = None
        self.track_state = trk.TrackState.OK
        pose_np = None
        if packed_np is not None:
            if vel_step is not None:
                # pre-init: the visual step's own velocity, relative to the
                # previous frame's pose even when that frame took the
                # reference-keyframe fallback (the reference drops the
                # velocity model there and loses fast motion, ROADMAP
                # queue 3)
                self.vel = tuple(vel_step)
            elif prev_pose is not None:
                dR = R2 @ prev_pose[0].T
                self.vel = (dR, t2 - dR @ prev_pose[1])
            else:
                self.vel = None
            pose_np = (packed_np[:9].reshape(3, 3).astype(np.float64),
                       packed_np[9:12].astype(np.float64))
            self._pose_dev = (R2, t2)
        else:
            dR = lie.so3_normalize(R2 @ self.R.T)
            self.vel = (dR, t2 - dR @ self.t)
        self._set_frame(frame, R2, t2, cur_obs)
        self.frames_since_kf += 1
        if not self.localization_only and (
                self._need_keyframe(n_inl2)
                or (not self.imu_ready and self.frames_since_kf >= 5)):
            self._insert_keyframe_inertial(frame, R2, t2, cur_obs, ts)
            if self.R is not R2:
                # IMU init or the window BA rebased the tracker: the packed
                # pose is stale
                pose_np = self._pose_dev = None
        if pose_np is None:
            self._record(ts)
            return self._pose_out()
        self._record_np(ts, *pose_np)
        return (*pose_np, self.track_state)

    def _handle_lost(self, frame, ts, R_pred, t_pred, cur_obs, cur_pred):
        """IMU dead-reckoning while RECENTLY_LOST, bounded by
        `recently_lost_time`; a speed blow-up or NaN (bad IMU) resets the
        active map. When the budget runs out, a map of >= 10 keyframes goes
        to the Atlas (a new one starts), a smaller one is dropped."""
        if cur_pred is not None:
            speed = float(torch.linalg.norm(cur_pred.v))
            if not np.isfinite(speed) or speed > self.icfg.max_speed:
                self._reset_active_map_bad_imu()
                self._record(ts)
                return self._pose_out()
        if self._lost_since is None:
            self._lost_since = ts
        if ts - self._lost_since <= self.icfg.recently_lost_time:
            self.track_state = trk.TrackState.RECENTLY_LOST
            if cur_pred is not None:
                self.body = cur_pred        # trust the IMU prediction
            self._set_frame(frame, R_pred, t_pred, cur_obs)
            self._record(ts)
            return self._pose_out()
        self.track_state = trk.TrackState.LOST
        self._lost_since = None
        if self.atlas is not None and len(self.kf_order) >= 10:
            self._spawn_new_map()
        else:
            self._reset_active_map_bad_imu()
        self._record(ts)
        return self._pose_out()

    def _reset_inertial_state(self):
        self.imu_ready = False
        self.body = None
        self.prior_H = torch.eye(15, device=self.device) * 1e6
        self.kf_imu_buf = []
        self.kf_windows = {}
        self.t_first_kf = None
        self.t_imu_init = None
        self._lost_since = None

    def _reset_active_map_bad_imu(self):
        """Drop the active map and restart (its scale and gravity are not to
        be trusted, so it is not kept)."""
        self._kf_jobs.clear()       # pending stages name dying slots
        self._freeze_trajectory()
        self.state = ms.empty(self.cfg.map, self.device)
        self.n_kf = 0
        self.kf_order = []
        self._free_kf_slots = []
        self.n_lm = 0
        self.track_state = trk.TrackState.NOT_INITIALIZED
        self.vel = None
        self.prev_obs = self.prev_octave = self.prev_angle = None
        self.frames_since_kf = 0
        self.ref_inliers = 1
        self.lost_frames = 0
        self._window_key = None
        self._reset_inertial_state()
        if self.loop_closer is not None:
            self.loop_closer.reset()

    def _spawn_new_map(self):
        super()._spawn_new_map()
        self._reset_inertial_state()

    # -- keyframes --

    def _on_keyframe_created(self, kf_id: int):
        # the inertial state goes onto the slot before the keyframe stages, so
        # that a loop correction rotates it and a merge carries it across
        st = self.state
        st.kf_vel[kf_id] = self.body.v
        st.kf_bg[kf_id] = self.body.bg
        st.kf_ba[kf_id] = self.body.ba

    def _insert_keyframe_inertial(self, frame, R, t, cur_obs, ts):
        # the previous keyframe's jobs land before the slot is peeked
        self._drain_kf_jobs()
        if self.t_first_kf is None:
            # the first keyframe after relocalising into a loaded map starts
            # the IMU chain: no window leads to it
            self.t_first_kf = ts
        else:
            # the allocator may hand out a reused slot: the IMU window lands
            # on the slot the keyframe gets
            self.kf_windows[self._peek_kf_slot()] = self._pad_kf_imu(self.kf_imu_buf)
        self.kf_imu_buf = []
        # visual stages + BA; an Atlas merge moves the keyframe's slot
        kf_id = self._insert_keyframe(frame, R, t, cur_obs)
        if not self.imu_ready:
            # keyframes of the IMU chain: all of a new map's, a loaded map's
            # since the relocalisation
            if (self.n_kf >= self.icfg.init_min_kfs
                    and len(self.kf_windows) + 1 >= self.icfg.init_min_kfs
                    and ts - self.t_first_kf >= self.icfg.init_min_time):
                with tracing.span("imu_init"):
                    self._initialize_imu()
        else:
            self._run_inertial_ba(kf_id)
            self._rebase_on(kf_id)
            self.prior_H = torch.eye(15, device=self.device) * 1e2
        # IMU init and the inertial BA rewrite keyframe poses
        self._refresh_ref_pose(kf_id)

    def _rebase_on(self, kf_id: int):
        self.R = self.state.kf_R[kf_id].clone()
        self.t = self.state.kf_t[kf_id].clone()
        self.body = self._kf_body(kf_id)

    def _merged_init_pairs(self, K: int, min_dt: float = 0.2):
        """Keyframe pairs for the IMU initialisation, merged to span at least
        `min_dt` of IMU data each (short baselines bias the scale through
        errors-in-variables). Returns (nodes, windows (maxP, S, 7) with S at
        most 2 kf_samples, idx_i, idx_j, valid), host arrays."""
        kf_ts = self.state.kf_ts.cpu().numpy()
        live = [k for k in self.kf_order if k < K]
        pos = {k: i for i, k in enumerate(live)}
        nodes = [live[0]]
        for k in live[1:]:
            if kf_ts[k] - kf_ts[nodes[-1]] >= min_dt or k == live[-1]:
                nodes.append(k)
        maxP = self.cfg.map.max_keyframes - 1
        cats = [None] * maxP
        idx_i = np.zeros(maxP, np.int64)
        idx_j = np.zeros(maxP, np.int64)
        valid = np.zeros(maxP, bool)
        for n in range(len(nodes) - 1):
            i, j = nodes[n], nodes[n + 1]
            rows = [w[w[:, 6] > 0] for m in live[pos[i] + 1:pos[j] + 1]
                    if (w := self.kf_windows.get(m)) is not None]
            cats[n] = np.concatenate(rows) if rows else np.zeros((0, 7), np.float32)
            idx_i[n], idx_j[n] = i, j
            valid[n] = len(cats[n]) > 0
        return nodes, pack_imu(cats, 2 * self.icfg.kf_samples), idx_i, idx_j, valid

    def _window_imu(self, window_ids):
        """(W-1, S, 7) sample windows joining consecutive window keyframes
        (newest-first ids) and their validity, on the device."""
        wins = [self.kf_windows.get(newer) if newer >= 0 and older >= 0 else None
                for newer, older in zip(window_ids[:-1], window_ids[1:])]
        valid = np.array([w is not None for w in wins], bool)
        return self._upload(pack_imu(wins, self.icfg.kf_samples)), self._upload(valid)

    def _full_map_imu_factors(self) -> vi_ba.VIInertialFactors:
        """Preintegration factors between all consecutive live keyframes,
        integrated at each pair's i-side bias (the full-map chain)."""
        maxP = self.cfg.map.max_keyframes - 1
        wins = [None] * maxP
        idx = np.zeros((2, maxP), np.int64)
        valid = np.zeros(maxP, bool)
        n = 0
        for a, b in zip(self.kf_order[:-1], self.kf_order[1:]):
            w = self.kf_windows.get(b)
            if w is None or n >= maxP:
                continue
            wins[n] = w
            idx[:, n] = a, b
            valid[n] = bool((w[:, 6] > 0).any())
            n += 1
        idx_d = self._upload(idx)
        pres = pre.integrate(self._upload(pack_imu(wins, self.icfg.kf_samples)),
                             self.state.kf_bg[idx_d[0]],
                             self.state.kf_ba[idx_d[0]], self.calib)
        return vi_ba.VIInertialFactors.from_preintegrations(
            idx_d[0], idx_d[1], pres, self._upload(valid))

    def _run_full_inertial_ba(self, pose_fixed=None):
        """Full-map 15-DoF VI BA (after the IMU initialisation, as the
        post-loop global BA, and over a merge seam); `pose_fixed` (K,) bool
        defaults to the first live keyframe alone."""
        if len(self.kf_order) < 3:
            return
        if pose_fixed is None:
            pose_fixed = np.zeros(self.cfg.map.max_keyframes, bool)
            pose_fixed[self.kf_order[0]] = True
        inertial = self._full_map_imu_factors()
        mesh = getattr(self.loop_closer, "mesh", None)
        if mesh is not None:
            # landmark-sharded over the closer's mesh, the visual GBA's layout
            self.state, _ = vg.run_global_vi_ba_sharded(
                self.state, inertial, trk.octave_inv_sigma2(self.cfg.orb, self.device),
                self.cam, self.bf, self.calib, self._upload(pose_fixed), mesh,
                n_levels=self.cfg.orb.n_levels, scale=self.cfg.orb.scale)
            return
        # compact to the live problem size (power-of-2 tiers)
        f_live = max(len(self.kf_order) * self.cfg.map.max_features, 1024)
        f_budget = 1 << int(np.ceil(np.log2(f_live)))
        l_budget = 1 << int(np.ceil(np.log2(max(2 * self.n_lm, 1024))))
        self.state, _ = vg.run_global_vi_ba(
            self.state, inertial, trk.octave_inv_sigma2(self.cfg.orb, self.device),
            self.cam, self.bf, self.calib, self._upload(pose_fixed),
            n_levels=self.cfg.orb.n_levels, scale=self.cfg.orb.scale,
            f_budget=f_budget, lm_budget=l_budget)

    def _post_loop_gba(self, kf_id: int):
        """After a loop correction, the full-map VI BA is the global BA
        (the facade disables the closer's visual one for inertial maps)."""
        if self.imu_ready:
            self._run_full_inertial_ba()

    def _merge_pose_fixed(self, weld_adj, weld_fixed) -> np.ndarray:
        """(K,) pose-fixed mask of the MergeInertialBA analogue: the seam
        window (the welding BA's keyframes) free, every other keyframe and
        the first live one fixed."""
        K = self.cfg.map.max_keyframes
        pose_fixed = np.ones(K, bool)
        wnd = torch.cat([weld_adj, weld_fixed]).cpu().numpy()
        pose_fixed[np.clip(wnd[wnd >= 0], 0, K - 1)] = False
        pose_fixed[self.kf_order[0]] = True
        return pose_fixed

    def _post_merge(self, new_kf, kf_off, n_cur, weld_adj, weld_fixed):
        # the IMU windows follow the active map's keyframes into their
        # shifted slots before anything reads them
        self.kf_windows = {k + kf_off: w for k, w in self.kf_windows.items()}
        if not self.imu_ready:
            super()._post_merge(new_kf, kf_off, n_cur, weld_adj, weld_fixed)
            return
        # MergeInertialBA analogue: 15-DoF BA over the seam window with
        # everything else fixed
        self._run_full_inertial_ba(pose_fixed=self._merge_pose_fixed(weld_adj, weld_fixed))

    def _run_inertial_ba(self, kf_id, init: bool = False):
        W = self.icfg.vi_window
        # newest-first live keyframes (slots may be sparse after culling;
        # kf_windows[k] spans from k's live predecessor)
        ids = (self.kf_order[-W:][::-1] + [-1] * W)[:W]
        kf_imu, imu_valid = self._window_imu(ids)
        with tracing.span("vi_local_ba"):
            self.state = inertial_local_ba(
                self.state, self._upload(np.asarray(ids, np.int64)), kf_imu, imu_valid,
                self.cam, self.bf, self.calib, self.cfg, self.icfg,
                hold_single_view=init and self.hold_single_view_at_init)
        self.n_vi_ba += 1

    def _initialize_imu(self):
        """3-stage IMU initialisation: per-pair preintegration, gravity
        bootstrap, inertial-only optimisation, gravity alignment of the map,
        then the window VI BA and the full-map VI BA."""
        K = self.n_kf
        dev = self.device
        st = self.state
        R_cb, t_cb = self.calib.cam_from_body()
        R_wb, p_wb = body_from_cam(st.kf_R[:K], st.kf_t[:K], R_cb, t_cb)
        # zero-bias preintegrations between keyframe pairs merged to >= 0.2 s
        nodes, wins, idx_i, idx_j, pvalid = self._merged_init_pairs(K)
        zero = torch.zeros(3, device=dev)
        pres = pre.integrate(self._upload(wins), zero, zero, self.calib)
        idx_i_d, pvalid_d = self._upload(idx_i), self._upload(pvalid)
        R_wg = ii.gravity_bootstrap(R_wb[idx_i_d], pres.dV, pvalid_d)
        # velocities by finite differences
        kf_ts = st.kf_ts[:K].cpu().numpy()
        self.t_imu_init = float(kf_ts[-1])
        dts = np.maximum(np.diff(kf_ts), 1e-3)
        p_np = p_wb.cpu().numpy()
        v0 = np.zeros((K, 3), np.float32)
        v0[:-1] = (p_np[1:] - p_np[:-1]) / dts[:, None]
        v0[-1] = v0[-2]
        factors = ii.factors_from_preintegrations(idx_i, idx_j, pres, pvalid)
        seed_scales = [1.0]
        sv_pos = sv_rot = 0.0
        if not self.icfg.fix_scale:
            # free scale: seed from the closed-form alignment when it is
            # well-posed and multi-start over log-spaced scales
            seed_scales = [0.25, 1.0, 4.0, 16.0]
            v_al, g_al, s_al = ii.visual_inertial_alignment(R_wb, p_wb, factors)
            if np.isfinite(s_al) and 1e-3 < s_al < 1e3:
                seed_scales = [float(s_al)] + seed_scales
                g_dir = -g_al / max(np.linalg.norm(g_al), 1e-9)
                R_wg = ii.gravity_bootstrap(
                    torch.eye(3, device=dev)[None], self._upload(g_dir[None]),
                    torch.ones(1, dtype=torch.bool, device=dev))
                v0 = np.asarray(v_al, np.float32) / max(float(s_al), 1e-6)
            # errors-in-variables whitening floors: ~10% of the median
            # keyframe baseline (1 significant digit), 0.3 degrees
            bas = np.linalg.norm(np.diff(p_np, axis=0), axis=1)
            sv_pos = 0.1 * float(np.median(bas)) if bas.size else 0.0
            sv_pos = float(f"{sv_pos:.0e}") if sv_pos > 0 else 0.0
            sv_rot = 5e-3
        # rotate the world to put the bootstrap gravity along -Z first
        R_gw = R_wg.T
        init_cfg = ii.InertialInitConfig(fix_scale=self.icfg.fix_scale, n_iters=60,
                                         sigma_vis_rot=sv_rot, sigma_vis_pos=sv_pos)
        best = None
        for s_init in seed_scales:
            res = ii.inertial_optimization(
                R_gw @ R_wb, p_wb @ R_gw.T, self._upload(v0) @ R_gw.T, factors,
                init_cfg, scale_init=s_init)
            c = float(res[-1][-1])
            if best is None or c < best[0]:
                best = (c, res)
        v, bg, ba, Rwg2, scale, _ = best[1]
        # total world correction: the refined gravity on top of the bootstrap
        kf_R2, kf_t2, _, lm2 = ii.apply_scaled_rotation(
            st.kf_R, st.kf_t, st.kf_vel, st.lm_pos, Rwg2.T @ R_gw, scale)
        st.kf_R.copy_(kf_R2)
        st.kf_t.copy_(kf_t2)
        st.lm_pos.copy_(lm2)
        # v lives in the bootstrap-rotated frame; the final world applies
        # Rwg2^T on top of it
        st.kf_vel.zero_()
        st.kf_vel[:K] = scale * (v @ Rwg2)
        st.kf_bg[:K] = bg
        st.kf_ba[:K] = ba
        self.state = ms.update_landmark_stats(st._replace(epoch=st.epoch + 1),
                                              self.cfg.orb.n_levels, self.cfg.orb.scale)
        kf_last = K - 1
        self._rebase_on(kf_last)
        self.prior_H = torch.eye(15, device=dev) * 1e2
        self.vel = None
        self.imu_ready = True
        # the window VI BA first (steadies the newest keyframes), then the
        # full-map VI BA
        self._run_inertial_ba(kf_last, init=True)
        self._run_full_inertial_ba()
        self._rebase_on(kf_last)


class MonoInertialTracker(MonoInit, StereoInertialTracker):
    """Monocular-inertial SLAM (IMU_MONOCULAR sensor mode), sync mode: the
    two-view initialisation and the monocular keyframe rule (`MonoInit`),
    then the visual-inertial loop of StereoInertialTracker, whose IMU
    initialisation estimates the scale (`fix_scale=False`) and brings the
    map to metric. The motion model keeps the narrow (7, 14) px radii: the
    IMU prediction centres the window well, and a wide first window on
    repeated texture admits aliased matches that bias the scale.

    Every row is monocular here, so the single-view hold of the stereo
    tracker's initialisation would pin the window to the map's pre-init
    scale (chip_smoke phase 17 read a Horn scale of 1.28 with it): the
    initialisation's window BA leaves those landmarks free."""

    hold_single_view_at_init = False

    def __init__(self, cam: Camera, calib: pre.ImuCalib,
                 cfg: trk.TrackerConfig = trk.TrackerConfig(),
                 icfg: InertialConfig = InertialConfig(fix_scale=False, init_min_kfs=6,
                                                       init_min_time=2.0),
                 *, device, loop_closer=None, relocalizer=None, atlas=None,
                 init_window: float = 100.0):
        if icfg.fix_scale:
            raise ValueError("the monocular-inertial tracker estimates the scale: "
                             "InertialConfig(fix_scale=False)")
        super().__init__(cam, 0.0, calib, mono_config(cfg), icfg, device=device,
                         loop_closer=loop_closer, relocalizer=relocalizer, atlas=atlas)
        self._mono_setup(init_window)
        self.match_radius = (7.0, 14.0)

    def process_mono_inertial(self, img, ts: float, imu_np):
        """imu_np: (n, 7) float32 [acc (3), gyro (3), dt] samples since the
        previous frame."""
        frame = build_mono_frame(self._upload_image(img), self._ts(ts), self.cfg.orb)
        return self._track_inertial(frame, ts, imu_np)

    def _initialize(self, frame) -> bool:
        prev_ref = self.ref_frame
        ok = super()._initialize(frame)
        if ok:
            # the IMU window joining the two initial keyframes (buffered
            # since the reference frame was chosen)
            self.kf_windows[1] = self._pad_kf_imu(self.kf_imu_buf)
        elif self.ref_frame is not prev_ref:
            self.kf_imu_buf = []        # a new reference: the window restarts
        return ok

    def _reset_active_map_bad_imu(self):
        super()._reset_active_map_bad_imu()
        self.ref_frame = None
