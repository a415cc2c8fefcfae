"""Stereo tracking front end (port of orb_slam3_vio_fixes_tpu/frontend/tracking.py).

Device functions (frame matching, pose optimisation, keyframe insertion,
triangulation/fusion, local BA) take and return tensors; `StereoTracker` is
the host state machine in SYNC mode: every frame's decisions complete before
the next frame starts (the order the reference's pipelined modes are defined
against). Its subclass hooks (`_can_cull`, `_filter_culls`, `_on_culled`,
`_peek_kf_slot`, `_freeze_trajectory`) carry the stereo-inertial tracker of
frontend/inertial_tracking.py. Not ported yet: software pipelining /
speculation, asynchronous keyframe jobs, loop closing, relocalisation,
Atlas, the fisheye rig, the RGB-D and monocular entries.

The map is updated in place (slam_map/map_state.py); the tracker keeps
clones of any row it holds across a map write.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from orb_slam3_vio_fixes_tpu_torch.frontend import local_mapping as lm_mod
from orb_slam3_vio_fixes_tpu_torch.frontend.frame import FrameData, build_stereo_frame_impl
from orb_slam3_vio_fixes_tpu_torch.ops import image as image_ops
from orb_slam3_vio_fixes_tpu_torch.ops import matching, orb
from orb_slam3_vio_fixes_tpu_torch.optim import ba_core
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms
from orb_slam3_vio_fixes_tpu_torch.utils import lie
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera, f32, in_image, project, unproject
from orb_slam3_vio_fixes_tpu_torch.utils.linalg import compact_indices, topk_stable


class TrackerConfig(NamedTuple):
    orb: orb.ORBConfig = orb.ORBConfig()
    map: ms.MapConfig = ms.MapConfig()
    width: int = 752
    height: int = 480
    max_local_lm: int = 2048
    ba_window: int = 8
    ba_fixed: int = 4
    th_depth_factor: float = 35.0
    min_kf_inliers: int = 25
    kf_inlier_ratio: float = 0.75
    max_frames_between_kf: int = 20
    new_lm_budget: int = 512
    kf_cull_every: int = 3
    kf_cull_max: int = 4
    enable_kf_culling: bool = True
    enable_growth: bool = True
    ba_anchors: int = 16
    po_rounds: int = 2
    po_iters: int = 5
    rot_check_motion: bool = False
    ba_factor_budget: int = 8192
    ba_lm_budget: int = 3072
    ba_cg_iters: int = 12
    ba_rounds: int = 2
    ba_iters: int = 3


def octave_inv_sigma2(cfg: orb.ORBConfig, device) -> torch.Tensor:
    sf = image_ops.scale_factors(cfg.n_levels, cfg.scale, device=device)
    return 1.0 / (sf * sf)


def predict_scale(dist, maxdist, n_levels=8, scale=1.2):
    """Predicted pyramid octave from observation distance."""
    ratio = torch.clamp(maxdist / torch.clamp(dist, min=1e-9), min=1e-9)
    lvl = torch.ceil(torch.log(ratio) / f32(math.log(scale))).to(torch.int32)
    return torch.clamp(lvl, 0, n_levels - 1)


def match_previous(state, prev_obs, prev_octave, prev_angle, R_pred, t_pred,
                   frame: FrameData, cam: Camera, bf: float, th: float,
                   cfg: TrackerConfig):
    """Motion-model matching: project the previous frame's landmarks with the
    predicted pose and window-search the new frame. Returns (cur_obs, n)."""
    L = state.lm_pos.shape[0]
    ids = prev_obs.to(torch.int64).clamp(0, L - 1)
    has = (prev_obs >= 0) & state.lm_valid[ids]
    X = state.lm_pos[ids]
    Xc = X @ R_pred.T + t_pred
    uv = project(cam, Xc)
    z = Xc[:, 2]
    ur = uv[:, 0] - bf / torch.clamp(z, min=1e-6)
    visible = has & (z > 0) & in_image(uv, cfg.width, cfg.height)
    sf = image_ops.scale_factors(cfg.orb.n_levels, cfg.orb.scale, device=X.device)
    radius = th * sf[prev_octave.to(torch.int64).clamp(0, cfg.orb.n_levels - 1)]
    res = matching.search_by_projection(
        uv, visible, state.lm_desc[ids], prev_octave, radius,
        frame.uv, frame.valid, frame.desc, frame.octave,
        proj_ur=ur, feat_ur=frame.ur)
    N = frame.uv.shape[0]
    matched = res.idx >= 0
    if cfg.rot_check_motion:
        matched = matching.rotation_consistency(prev_angle, frame.angle, res.idx,
                                                matched)
    cur_obs = ms.set_masked(torch.full((N,), -1, dtype=torch.int32, device=X.device),
                            res.idx.to(torch.int64).clamp(0, N - 1), matched, prev_obs)
    return cur_obs, matched.sum()


def _packed(R2, t2, n_m, n_inl2, frame: FrameData, cur_obs, cam: Camera, bf: float,
            cfg: TrackerConfig) -> torch.Tensor:
    """The per-frame decision vector pulled by the host in one copy: pose
    (12) + matches, inliers, close tracked, close untracked."""
    baseline = bf / cam.fx
    close = ((frame.depth > 0) & (frame.depth < cfg.th_depth_factor * baseline)
             & frame.valid)
    tracked = cur_obs >= 0
    stats = torch.stack([n_m.to(torch.float32), n_inl2.to(torch.float32),
                         (close & tracked).sum().to(torch.float32),
                         (close & ~tracked).sum().to(torch.float32)])
    return torch.cat([R2.reshape(-1), t2, stats])


def track_step_impl(state, prev_obs, prev_octave, prev_angle, R_prev, t_prev,
                    dR_vel, dt_vel, frame: FrameData, window_kfs, cam: Camera,
                    bf: float, th_narrow: float, th_wide: float, th_local: float,
                    cfg: TrackerConfig, has_vel: bool = False):
    """The per-frame OK path: constant-velocity prediction, motion-model
    matching (retried with the wide radius when < 20 matches: a host branch
    on one synced count, where the reference used lax.cond), motion-only
    pose opt, local-map tracking, velocity candidate.

    Returns (R2, t2, cur_obs, packed, R_pred, t_pred, dR_new, dt_new)."""
    if has_vel:
        R_pred = dR_vel @ R_prev
        t_pred = dR_vel @ t_prev + dt_vel
    else:
        R_pred, t_pred = R_prev, t_prev
    cur_obs, n_m = match_previous(state, prev_obs, prev_octave, prev_angle,
                                  R_pred, t_pred, frame, cam, bf, th_narrow, cfg)
    if int(n_m) < 20:
        cur_obs, n_m = match_previous(state, prev_obs, prev_octave, prev_angle,
                                      R_pred, t_pred, frame, cam, bf, th_wide, cfg)
    R1, t1, cur_obs, _ = pose_opt_from_obs(state, R_pred, t_pred, frame, cur_obs,
                                           cam, bf, cfg)
    R2, t2, cur_obs, n_inl2 = track_local_map(state, R1, t1, frame, cur_obs,
                                              window_kfs, cam, bf, th_local, cfg)
    packed = _packed(R2, t2, n_m, n_inl2, frame, cur_obs, cam, bf, cfg)
    dR_new = lie.so3_normalize(R2 @ R_prev.T)
    dt_new = t2 - dR_new @ t_prev
    return R2, t2, cur_obs, packed, R_pred, t_pred, dR_new, dt_new


def track_reference_kf(state, ref_kf: int, R_init, t_init, frame: FrameData,
                       window_kfs, cam: Camera, bf: float, th_local: float,
                       cfg: TrackerConfig):
    """Fallback: windowless mutual descriptor matching against the reference
    keyframe's bound features, then pose opt + local map.
    Returns (R, t, cur_obs, packed)."""
    K, N = state.kf_obs.shape
    L = state.lm_pos.shape[0]
    k = min(max(int(ref_kf), 0), K - 1)
    obs = state.kf_obs[k]
    lids = obs.to(torch.int64).clamp(0, L - 1)
    has = (obs >= 0) & state.lm_valid[lids] & state.kf_feat_valid[k]
    res = matching.match_descriptors(state.kf_desc[k], has, frame.desc,
                                     frame.valid, ratio=0.7,
                                     max_dist=matching.TH_LOW, mutual=True)
    matched = res.idx >= 0
    ok = matching.rotation_consistency(state.kf_angle[k], frame.angle, res.idx,
                                       matched)
    cur_obs = ms.set_masked(torch.full((N,), -1, dtype=torch.int32, device=obs.device),
                            res.idx.to(torch.int64).clamp(0, N - 1), ok, obs)
    n_m = ok.sum()
    R1, t1, cur_obs, _ = pose_opt_from_obs(state, R_init, t_init, frame, cur_obs,
                                           cam, bf, cfg)
    R2, t2, cur_obs, n_inl2 = track_local_map(state, R1, t1, frame, cur_obs,
                                              window_kfs, cam, bf, th_local, cfg)
    return R2, t2, cur_obs, _packed(R2, t2, n_m, n_inl2, frame, cur_obs, cam, bf, cfg)


def pose_opt_from_obs(state, R, t, frame: FrameData, cur_obs, cam: Camera,
                      bf: float, cfg: TrackerConfig):
    """Motion-only pose optimisation over the frame's bindings; outlier
    bindings are cleared. Returns (R, t, cur_obs, n_inliers)."""
    L = state.lm_pos.shape[0]
    ids = cur_obs.to(torch.int64).clamp(0, L - 1)
    act = (cur_obs >= 0) & state.lm_valid[ids] & frame.valid
    uvr = torch.cat([frame.uv, frame.ur[:, None]], dim=-1)
    inv_s2 = octave_inv_sigma2(cfg.orb, frame.uv.device)[
        frame.octave.to(torch.int64).clamp(0, cfg.orb.n_levels - 1)]
    res = ba_core.pose_optimize(
        R, t, state.lm_pos[ids], uvr, inv_s2, act, cam, bf,
        ba_core.LMConfig(n_rounds=cfg.po_rounds, n_iters=cfg.po_iters))
    new_obs = torch.where(res.inlier, cur_obs, torch.full_like(cur_obs, -1))
    return res.R, res.t, new_obs, res.n_inliers


def local_map_search(state, R, t, frame: FrameData, cur_obs, window_kfs,
                     cam: Camera, bf: float, th: float, cfg: TrackerConfig):
    """Project the window keyframes' landmarks and widen the frame's
    bindings (features already bound stay bound)."""
    K, N = state.kf_obs.shape
    L = state.lm_pos.shape[0]
    dev = cur_obs.device
    safe_w = window_kfs.to(torch.int64).clamp(0, K - 1)
    w_ok = (window_kfs >= 0) & state.kf_valid[safe_w]
    obs_rows = torch.where(w_ok[:, None], state.kf_obs[safe_w],
                           torch.full((), -1, dtype=torch.int32, device=dev))
    flat = obs_rows.reshape(-1).to(torch.int64)
    cand_mask = ms.set_masked(torch.zeros(L, dtype=torch.bool, device=dev),
                               flat.clamp(0, L - 1), flat >= 0, True)
    cand_mask &= state.lm_valid
    cand_idx, cand_sel = compact_indices(cand_mask, cfg.max_local_lm)
    cand_ok = cand_mask[cand_idx] & cand_sel

    X = state.lm_pos[cand_idx]
    Xc = X @ R.T + t
    uv = project(cam, Xc)
    z = Xc[:, 2]
    ur = uv[:, 0] - bf / torch.clamp(z, min=1e-6)
    C = -R.T @ t
    d = X - C[None]
    dist = torch.linalg.norm(d, dim=-1)
    view_cos = (d * state.lm_normal[cand_idx]).sum(-1) / torch.clamp(dist, min=1e-9)
    vis = (cand_ok & (z > 0) & in_image(uv, cfg.width, cfg.height)
           & (dist >= 0.8 * state.lm_mindist[cand_idx])
           & (dist <= 1.2 * state.lm_maxdist[cand_idx]) & (view_cos > 0.5))
    octv = predict_scale(dist, state.lm_maxdist[cand_idx], cfg.orb.n_levels,
                         cfg.orb.scale)
    sf = image_ops.scale_factors(cfg.orb.n_levels, cfg.orb.scale, device=dev)
    base_r = torch.where(view_cos > 0.998, 2.5, 4.0)
    radius = th * base_r * sf[octv.to(torch.int64)]
    res = matching.search_by_projection(
        uv, vis, state.lm_desc[cand_idx], octv, radius,
        frame.uv, frame.valid, frame.desc, frame.octave, feat_taken=cur_obs >= 0,
        proj_ur=ur, feat_ur=frame.ur, ratio=0.8)
    matched = res.idx >= 0
    return ms.set_masked(cur_obs, res.idx.to(torch.int64).clamp(0, N - 1), matched,
                         cand_idx.to(torch.int32))


def track_local_map(state, R, t, frame: FrameData, cur_obs, window_kfs,
                    cam: Camera, bf: float, th: float, cfg: TrackerConfig):
    """Local-map search + the second pose optimisation."""
    cur_obs = local_map_search(state, R, t, frame, cur_obs, window_kfs, cam, bf,
                               th, cfg)
    return pose_opt_from_obs(state, R, t, frame, cur_obs, cam, bf, cfg)


def create_keyframe_impl(state, kf_id: int, n_lm, frame: FrameData, R, t,
                         cur_obs, prev_kf_id: int, cam: Camera, bf: float,
                         cfg: TrackerConfig, spawn_all: bool = False):
    """Insert a keyframe: bind tracked landmarks, spawn new ones from close
    stereo depths (closest first, at least 100). Returns (state, n_created).

    Unlike the reference, spawned rows that would land on or past the
    scratch slot L-1 are dropped (the reference drops the write but keeps
    the binding); map growth keeps this from happening in practice."""
    N = frame.uv.shape[0]
    L = state.lm_pos.shape[0]
    dev = frame.uv.device
    th_depth = cfg.th_depth_factor * (bf / cam.fx)
    cand = frame.valid & (cur_obs < 0) & (frame.depth > 0)
    depth_key = torch.where(cand, frame.depth, torch.full_like(frame.depth, float("inf")))
    order = torch.argsort(depth_key, stable=True)
    rank = torch.empty(N, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(N, device=dev)
    if spawn_all:
        is_new = cand
    else:
        is_new = cand & ((frame.depth < th_depth) | (rank < 100))
    is_new = is_new & (rank < cfg.new_lm_budget)
    slot_off = torch.cumsum(is_new.to(torch.int64), 0) - 1
    is_new = is_new & ((n_lm + slot_off) < L - 1)
    slots = torch.where(is_new, n_lm + slot_off, torch.full_like(slot_off, L - 1))

    Xc = unproject(cam, frame.uv) * frame.depth[:, None]
    Xw = (Xc - t[None]) @ R
    C = -R.T @ t
    d = Xw - C[None]
    dist = torch.linalg.norm(d, dim=-1)
    normal = d / torch.clamp(dist[:, None], min=1e-9)
    sf = image_ops.scale_factors(cfg.orb.n_levels, cfg.orb.scale, device=dev)
    maxdist = dist * sf[frame.octave.to(torch.int64).clamp(0, cfg.orb.n_levels - 1)]
    state = ms.add_landmarks(state, slots, Xw, frame.desc, normal,
                             maxdist / sf[-1], maxdist, kf_id, is_new)
    obs = torch.where(is_new, slots.to(torch.int32), cur_obs)
    zeros3 = torch.zeros(3, device=dev)
    state = ms.insert_keyframe(state, kf_id, R, t, frame.ts, zeros3, zeros3, zeros3,
                               prev_kf_id, frame.uv, frame.ur, frame.octave,
                               frame.angle, frame.desc, frame.valid, obs,
                               frame.depth)
    return state, is_new.sum()


def kf_create_map(state, kf_id: int, n_lm, frame: FrameData, R, t, cur_obs,
                  prev_kf_id: int, neighbor_ids, cam: Camera, bf: float,
                  cfg: TrackerConfig, lcfg: lm_mod.LocalMapConfig):
    """Keyframe insertion + close-stereo spawning + triangulation over the
    neighbours + duplicate fusion. Returns (state, n_lm_after as a 0-dim
    tensor)."""
    state, n_created = create_keyframe_impl(state, kf_id, n_lm, frame, R, t,
                                            cur_obs, prev_kf_id, cam, bf, cfg)
    n_after = n_lm + n_created
    state, n_tri = lm_mod.create_new_landmarks_impl(state, kf_id, neighbor_ids,
                                                    n_after, cam, bf, lcfg)
    state = lm_mod.fuse_duplicates_impl(state, kf_id, neighbor_ids, cam, lcfg)
    return state, n_after + n_tri


def select_ba_window_impl(state, cur: int, first: int, cfg: TrackerConfig):
    """Covisibility window for local BA: (adj (ba_window,), fixed
    (ba_anchors,)) keyframe ids, -1 padded."""
    K = state.kf_obs.shape[0]
    dev = state.kf_obs.device
    cov = ms.covisibility(state).to(torch.float32)
    valid = state.kf_valid
    row = torch.where(valid, cov[cur], torch.full((), -1.0, device=dev))
    row[cur] = -1.0
    row[first] = -1.0
    top_s, top_i = topk_stable(row, min(cfg.ba_window - 1, K - 1))
    adj = torch.cat([torch.full((1,), cur, dtype=torch.int64, device=dev),
                     torch.where(top_s > 0, top_i, torch.full_like(top_i, -1))])
    adj_mask = ms.set_masked(torch.zeros(K, dtype=torch.bool, device=dev),
                              adj.clamp(0, K - 1), adj >= 0, True)
    fscore = cov @ adj_mask.to(torch.float32)
    fscore = torch.where(valid & ~adj_mask, fscore, torch.full((), -1.0, device=dev))
    fscore[first] = torch.where(adj_mask[first], -1.0, float("inf"))
    fs, fi = topk_stable(fscore, min(cfg.ba_anchors, K))
    return adj, torch.where(fs > 0, fi, torch.full_like(fi, -1))


def local_ba_impl(state, adj_kfs, fixed_kfs, cam: Camera, bf: float,
                  cfg: TrackerConfig):
    """Local BA over the window: window poses and the landmarks they observe
    adjust, anchors fixed, factors and landmarks compacted to budgets, outlier
    observations unbound. Returns (state, n_truncated)."""
    window = torch.cat([adj_kfs, fixed_kfs])
    W = window.shape[0]
    K, N = state.kf_obs.shape
    L = state.lm_pos.shape[0]
    dev = window.device
    safe_w = window.clamp(0, K - 1)
    w_ok = (window >= 0) & state.kf_valid[safe_w]
    fixed = torch.cat([torch.zeros(adj_kfs.shape[0], dtype=torch.bool, device=dev),
                       torch.ones(fixed_kfs.shape[0], dtype=torch.bool, device=dev)]) | ~w_ok
    pose_idx, lm_idx, uvr, inv_s2, valid = ms.ba_factors_from_map(
        state, window, octave_inv_sigma2(cfg.orb, dev))
    F_full = pose_idx.shape[0]
    F_budget = min(F_full, cfg.ba_factor_budget)
    n_trunc = torch.clamp(valid.sum() - F_budget, min=0)
    order, order_ok = compact_indices(valid, F_budget)
    factors = ba_core.ReprojFactors(pose_idx[order], lm_idx[order], uvr[order],
                                    inv_s2[order], valid[order] & order_ok)
    lm_budget = min(L, cfg.ba_lm_budget)
    used = ms.set_masked(torch.zeros(L, dtype=torch.bool, device=dev),
                          factors.lm_idx, factors.valid, True)
    sub_idx, sub_ok = compact_indices(used, lm_budget)
    remap = torch.full((L + 1,), -1, dtype=torch.int64, device=dev)
    remap[torch.where(sub_ok, sub_idx, torch.full_like(sub_idx, L))] = torch.arange(
        lm_budget, device=dev)
    lm_local = remap[:L][factors.lm_idx]
    got_slot = lm_local >= 0
    n_trunc = n_trunc + (factors.valid & ~got_slot).sum()
    factors = factors._replace(lm_idx=lm_local.clamp(0, lm_budget - 1),
                               valid=factors.valid & got_slot)
    used_sub = used[sub_idx] & sub_ok
    n_obs_local = torch.zeros(lm_budget, dtype=torch.int64, device=dev).index_add_(
        0, factors.lm_idx, factors.valid.to(torch.int64))
    problem = ba_core.BAProblem(
        R=state.kf_R[safe_w], t=state.kf_t[safe_w], pose_fixed=fixed,
        lm=state.lm_pos[sub_idx], lm_valid=state.lm_valid[sub_idx] & used_sub,
        lm_fixed=n_obs_local < 2, factors=factors, cam=cam, bf=bf)
    out, inlier_c, _ = ba_core.bundle_adjust(
        problem, ba_core.LMConfig(n_rounds=cfg.ba_rounds, n_iters=cfg.ba_iters,
                                  cg_iters=cfg.ba_cg_iters))
    inlier = torch.ones(F_full + 1, dtype=torch.bool, device=dev)
    inlier[torch.where(order_ok, order, torch.full_like(order, F_full))] = \
        inlier_c | ~factors.valid
    inlier = inlier[:F_full]
    # write back: a window slot may repeat only as -1 padding (clamped to 0),
    # which never updates; sub_idx pads (index 0) never update either
    upd = w_ok & ~fixed
    lm_upd = used_sub & state.lm_valid[sub_idx] & ~problem.lm_fixed
    state.kf_R.copy_(ms.set_masked(state.kf_R, safe_w, upd, out.R))
    state.kf_t.copy_(ms.set_masked(state.kf_t, safe_w, upd, out.t))
    state.lm_pos.copy_(ms.set_masked(state.lm_pos, sub_idx, lm_upd, out.lm))
    drop = (valid & ~inlier).reshape(W, N) & w_ok[:, None]
    rows = state.kf_obs[safe_w]
    state.kf_obs.copy_(ms.set_masked(state.kf_obs, safe_w, w_ok,
                                     torch.where(drop, torch.full_like(rows, -1), rows)))
    return state._replace(epoch=state.epoch + 1), n_trunc


def kf_ba_stage(state, cur: int, first: int, cam: Camera, bf: float,
                cfg: TrackerConfig):
    adj, fixed = select_ba_window_impl(state, cur, first, cfg)
    return local_ba_impl(state, adj, fixed, cam, bf, cfg)


class TrackState:
    NOT_INITIALIZED = "NOT_INITIALIZED"
    OK = "OK"
    RECENTLY_LOST = "RECENTLY_LOST"
    LOST = "LOST"


class StereoTracker:
    """Host orchestrator for stereo SLAM in sync mode: build frame ->
    motion-model match -> pose opt -> local-map track -> keyframe decision ->
    (keyframe insert + triangulation + fusion + local BA + culling)."""

    def __init__(self, cam: Camera, bf: float, cfg: TrackerConfig = TrackerConfig(),
                 *, device):
        ba_core.set_full_f32()
        self.device = torch.device(device)
        self.cam = cam
        self.bf = f32(bf)
        self.cfg = cfg
        self.match_radius = (7.0, 14.0)     # motion-model search th (widened)
        self.th_local_base = 1.0            # local-map search multiplier
        self.state = ms.empty(cfg.map, self.device)
        self.track_state = TrackState.NOT_INITIALIZED
        self.ba_truncated = torch.zeros((), dtype=torch.int64, device=self.device)
        self.n_kf = 0
        self._free_kf_slots = []
        self.n_lm = 0
        self.kf_order = []
        self.R = torch.eye(3, device=self.device)
        self.t = torch.zeros(3, device=self.device)
        self.vel = None
        self.prev_obs = None
        self.prev_octave = None
        self.prev_angle = None
        self.frames_since_kf = 0
        self.ref_inliers = 1
        self.last_n_inliers = 0
        self._frame_stats = None
        self.traj = []
        self.ref_kf = -1
        self._ref_pose = (np.eye(3), np.zeros(3))
        self._kf_nlm_dev = None
        self._kf_seq = 0
        self._window_key = None
        self._window = None

    # -- per-frame entry points --

    def _upload_pair(self, img_l, img_r) -> torch.Tensor:
        """(2, H, W) uint8 device tensor; host floats quantise to uint8 like
        the reference's upload."""
        if isinstance(img_l, torch.Tensor) and img_l.ndim == 3:
            return img_l.to(self.device)
        a, b = np.asarray(img_l), np.asarray(img_r)
        if a.dtype != np.uint8:
            a = np.clip(np.rint(a), 0, 255).astype(np.uint8)
            b = np.clip(np.rint(b), 0, 255).astype(np.uint8)
        pair = torch.from_numpy(np.stack([a, b]))
        if self.device.type == "cuda":
            # a copy from pageable memory would wait for the stream to drain
            pair = pair.pin_memory()
        return pair.to(self.device, non_blocking=True)

    def _build_stereo(self, img_l, img_r, ts: float) -> FrameData:
        imgs = self._upload_pair(img_l, img_r)
        return build_stereo_frame_impl(
            imgs[0], imgs[1], torch.full((), ts, dtype=torch.float32, device=self.device),
            self.cam, self.bf, self.cfg.orb)

    def process_stereo(self, img_l, img_r, ts: float):
        return self.process_frame(self._build_stereo(img_l, img_r, ts), ts)

    def _local_search_th(self) -> float:
        """Local-map search radius multiplier: wider while recently lost (the
        reference's post-relocalisation widening waits for relocalisation)."""
        if self.track_state == TrackState.RECENTLY_LOST:
            return 3.0
        return self.th_local_base

    def _local_window(self) -> torch.Tensor:
        """The recent keyframes of the local map, newest first, -1 padded.
        Rebuilt only when the keyframe order changes: a host->device copy
        per frame would synchronise the stream."""
        w = self.cfg.ba_window + self.cfg.ba_fixed
        recent = tuple(self.kf_order[-w:][::-1])
        if self._window_key != recent:
            ids = np.full(w, -1, np.int64)
            ids[:len(recent)] = recent
            self._window = torch.as_tensor(ids, device=self.device)
            self._window_key = recent
        return self._window

    def process_frame(self, frame: FrameData, ts: float):
        cfg = self.cfg
        if self.track_state == TrackState.NOT_INITIALIZED:
            self._initialize(frame)
            self._record(ts)
            return self.R.cpu().numpy(), self.t.cpu().numpy(), self.track_state
        # RECENTLY_LOST: without a relocaliser the motion-model attempt below
        # is the recovery path, as in the reference
        window = self._local_window()
        has_vel = self.vel is not None
        dR, dt = self.vel if has_vel else (None, None)
        outs = track_step_impl(
            self.state, self.prev_obs, self.prev_octave, self.prev_angle,
            self.R, self.t, dR, dt, frame, window, self.cam, self.bf,
            self.match_radius[0], self.match_radius[1], self._local_search_th(),
            cfg, has_vel=has_vel)
        return self._finalize_track(frame, ts, *outs, window)

    def _finalize_track(self, frame, ts, R2, t2, cur_obs, packed, R_pred, t_pred,
                        dR_new, dt_new, window):
        cfg = self.cfg
        packed = packed.cpu().numpy()       # the one device->host pull
        self._frame_stats = packed[12:].astype(np.int64)
        n_inl2_i = int(self._frame_stats[1])
        self.last_n_inliers = n_inl2_i
        fell_back = False
        if n_inl2_i < cfg.min_kf_inliers and self.ref_kf >= 0:
            fell_back = True
            R2, t2, cur_obs, packed = track_reference_kf(
                self.state, self.ref_kf, R_pred, t_pred, frame, window, self.cam,
                self.bf, self._local_search_th(), cfg)
            packed = packed.cpu().numpy()
            self._frame_stats = packed[12:].astype(np.int64)
            n_inl2_i = int(self._frame_stats[1])
            self.last_n_inliers = n_inl2_i
        if n_inl2_i < cfg.min_kf_inliers:
            self.track_state = TrackState.RECENTLY_LOST
            self._set_frame(frame, R_pred, t_pred, cur_obs)
            self._record(ts)
            return self.R.cpu().numpy(), self.t.cpu().numpy(), self.track_state
        self.track_state = TrackState.OK
        if fell_back:
            dR = lie.so3_normalize(R2 @ self.R.T)
            self.vel = (dR, t2 - dR @ self.t)
        else:
            self.vel = (dR_new, dt_new)
        self._set_frame(frame, R2, t2, cur_obs)
        self.frames_since_kf += 1
        if self._need_keyframe(n_inl2_i):
            self._insert_keyframe(frame, R2, t2, cur_obs)
        R_np = packed[:9].reshape(3, 3).astype(np.float64)
        t_np = packed[9:12].astype(np.float64)
        self._record_np(ts, R_np, t_np)
        return R_np, t_np, self.track_state

    # -- internals --

    def _record(self, ts):
        self._record_np(ts, self.R.cpu().numpy().astype(np.float64),
                        self.t.cpu().numpy().astype(np.float64))

    def _record_np(self, ts, R_cw, t_cw):
        """Log the pose relative to the reference keyframe (absolute before
        the first keyframe), so keyframe corrections reach the trajectory."""
        if self.ref_kf >= 0:
            R_rw, t_rw = self._ref_pose
            R_cr = R_cw @ R_rw.T
            self.traj.append([float(ts), self.ref_kf, R_cr, t_cw - R_cr @ t_rw])
        else:
            self.traj.append([float(ts), -1, np.array(R_cw), np.array(t_cw)])

    @property
    def trajectory(self):
        """Per-frame (ts, R_cw, t_cw) through the current keyframe poses."""
        if not self.traj:
            return []
        kf_R = self.state.kf_R.cpu().numpy().astype(np.float64)
        kf_t = self.state.kf_t.cpu().numpy().astype(np.float64)
        out = []
        for ts, ref, Rr, tr in self.traj:
            if ref < 0:
                out.append((ts, Rr, tr))
            else:
                out.append((ts, Rr @ kf_R[ref], Rr @ kf_t[ref] + tr))
        return out

    def keyframe_trajectory(self):
        kf_R = self.state.kf_R.cpu().numpy()
        kf_t = self.state.kf_t.cpu().numpy()
        kf_ts = self.state.kf_ts.cpu().numpy()
        return [(float(kf_ts[k]), kf_R[k], kf_t[k]) for k in self.kf_order]

    def _freeze_trajectory(self):
        """Make every keyframe-relative trajectory entry absolute; called
        before the active map and its keyframe slots go away (reset)."""
        self.ref_kf = -1
        if not any(e[1] >= 0 for e in self.traj):
            return
        kf_R = self.state.kf_R.cpu().numpy().astype(np.float64)
        kf_t = self.state.kf_t.cpu().numpy().astype(np.float64)
        for e in self.traj:
            _, ref, Rr, tr = e
            if ref >= 0:
                e[1], e[2], e[3] = -1, Rr @ kf_R[ref], Rr @ kf_t[ref] + tr

    def _refresh_ref_pose(self, kf_id: int, pose_np=None):
        """Cache T_rw of the reference keyframe (pulled from the map when
        `pose_np` is not given)."""
        self.ref_kf = int(kf_id)
        if pose_np is None:
            pose_np = (self.state.kf_R[kf_id].cpu().numpy().astype(np.float64),
                       self.state.kf_t[kf_id].cpu().numpy().astype(np.float64))
        self._ref_pose = pose_np

    def _set_frame(self, frame, R, t, cur_obs):
        self.R, self.t = R, t
        self.prev_obs = cur_obs
        self.prev_octave = frame.octave
        self.prev_angle = frame.angle

    def _initialize(self, frame) -> bool:
        """First frame with >= 40% features and >= 50 stereo points becomes
        KF0 at the origin; every valid-depth keypoint spawns a landmark."""
        counts = torch.stack([frame.valid.sum(),
                              ((frame.depth > 0) & frame.valid).sum()]).cpu()
        n_feat, n_stereo = int(counts[0]), int(counts[1])
        if n_feat < int(0.4 * frame.valid.shape[0]) or n_stereo < 50:
            return False
        R0 = torch.eye(3, device=self.device)
        t0 = torch.zeros(3, device=self.device)
        cur_obs = torch.full((frame.uv.shape[0],), -1, dtype=torch.int32,
                             device=self.device)
        self.state, n_created = create_keyframe_impl(
            self.state, 0, 0, frame, R0, t0, cur_obs, -1, self.cam, self.bf,
            self.cfg, spawn_all=True)
        self.n_kf = 1
        self.kf_order = [0]
        self.n_lm = int(n_created)
        self.prev_obs = self.state.kf_obs[0].clone()
        self.prev_octave = frame.octave
        self.prev_angle = frame.angle
        self.R, self.t = R0, t0
        self.track_state = TrackState.OK
        self.frames_since_kf = 0
        self.ref_inliers = self.n_lm
        self._refresh_ref_pose(0, (np.eye(3), np.zeros(3)))
        return True

    def _need_keyframe(self, n_inliers: int) -> bool:
        """Max frames (c1a), inlier ratio (c2), close-point health (c1c)."""
        cfg = self.cfg
        if self.track_state != TrackState.OK:
            return False
        c1a = self.frames_since_kf >= cfg.max_frames_between_kf
        c2 = n_inliers < cfg.kf_inlier_ratio * self.ref_inliers and n_inliers > 15
        c1c = int(self._frame_stats[2]) < 100 and int(self._frame_stats[3]) > 70
        return bool(c1a or c2 or c1c)

    def _lm_cfg(self) -> lm_mod.LocalMapConfig:
        cfg = self.cfg
        return lm_mod.LocalMapConfig(
            n_neighbors=3, new_lm_budget=cfg.new_lm_budget,
            n_levels=cfg.orb.n_levels, scale=cfg.orb.scale,
            width=cfg.width, height=cfg.height)

    def _maybe_grow(self):
        """Double keyframe or landmark capacity when it runs low."""
        if not self.cfg.enable_growth:
            return
        mc = self.cfg.map
        new_mc = mc
        if self.n_kf >= mc.max_keyframes - 2:
            new_mc = new_mc._replace(max_keyframes=2 * mc.max_keyframes)
        if self.n_lm >= mc.max_landmarks - 3 * self.cfg.new_lm_budget:
            new_mc = new_mc._replace(max_landmarks=2 * mc.max_landmarks)
        if new_mc is mc:
            return
        self.state = ms.grow_map(self.state, mc, new_mc)
        self.cfg = self.cfg._replace(map=new_mc)

    def _insert_keyframe(self, frame, R, t, cur_obs):
        """Keyframe insertion with every local-mapping stage inline:
        create + spawn + triangulate + fuse, local BA, culling, bookkeeping."""
        self._maybe_grow()
        kf_id = self._peek_kf_slot()
        if self._free_kf_slots and kf_id == self._free_kf_slots[0]:
            self._free_kf_slots.pop(0)
        prev_kf = self.kf_order[-1] if self.kf_order else -1
        lcfg = self._lm_cfg()
        neighbors = [-1] * lcfg.n_neighbors
        for i, kk in enumerate(self.kf_order[::-1][:lcfg.n_neighbors]):
            neighbors[i] = kk
        self.state, self._kf_nlm_dev = kf_create_map(
            self.state, kf_id, self.n_lm, frame, R, t, cur_obs, prev_kf,
            neighbors, self.cam, self.bf, self.cfg, lcfg)
        if kf_id == self.n_kf:
            self.n_kf += 1
        self.kf_order.append(kf_id)
        self.frames_since_kf = 0
        self._kf_seq += 1
        self._kf_stage_ba(kf_id)
        self._kf_stage_cull(kf_id, self._kf_seq)
        self._kf_stage_finalize(kf_id)
        return kf_id

    def _peek_kf_slot(self) -> int:
        """The slot the next `_insert_keyframe` takes (free-list head or the
        high-water cursor); subclasses that stamp per-keyframe side state
        call it before inserting."""
        return self._free_kf_slots[0] if self._free_kf_slots else self.n_kf

    def _kf_stage_ba(self, kf_id):
        self.state, n_tr = kf_ba_stage(self.state, kf_id, self.kf_order[0],
                                       self.cam, self.bf, self.cfg)
        self.ba_truncated = self.ba_truncated + n_tr

    def _kf_stage_cull(self, kf_id, seq):
        lcfg = self._lm_cfg()
        if seq % 2 == 0:
            g = lcfg.cull_grace_kfs
            recent = [-1] * g
            for i, k in enumerate(self.kf_order[-g:]):
                recent[i] = k
            self.state = lm_mod.cull_landmarks(self.state, self.n_kf, lcfg,
                                               recent_slots=recent)
        if (self.cfg.enable_kf_culling and self._can_cull()
                and seq % self.cfg.kf_cull_every == 0
                and len(self.kf_order) > self.cfg.ba_window + 2):
            self._cull_keyframes()

    def _can_cull(self) -> bool:
        """Subclass gate (the inertial tracker culls only after IMU init)."""
        return True

    def _filter_culls(self, cull):
        """Subclass veto of keyframes chosen for culling."""
        return cull

    def _on_culled(self, cull):
        """Subclass bookkeeping, called before the keyframes are excised."""

    def _kf_stage_finalize(self, kf_id):
        """One pull for the keyframe's bookkeeping scalars and pose; the
        frame's bindings follow the (fused / culled) keyframe row."""
        counts = torch.cat([
            torch.stack([self._kf_nlm_dev.to(torch.float32),
                         (self.state.kf_obs[kf_id] >= 0).sum().to(torch.float32)]),
            self.state.kf_R[kf_id].reshape(-1), self.state.kf_t[kf_id]]).cpu().numpy()
        self.n_lm = int(counts[0])
        self.ref_inliers = max(int(counts[1]), 1)
        self._refresh_ref_pose(kf_id, (counts[2:11].reshape(3, 3).astype(np.float64),
                                       counts[11:14].astype(np.float64)))
        self.prev_obs = self.state.kf_obs[kf_id].clone()

    def _cull_keyframes(self):
        """Excise redundant keyframes (protected: the first, the BA window and
        the reference keyframe); trajectory entries that referenced a culled
        keyframe are re-based onto its nearest live predecessor."""
        cfg = self.cfg
        w = cfg.ba_window + cfg.ba_fixed
        protect = [-1] * (w + 2)
        for i, k in enumerate(self.kf_order[-w:] + [self.kf_order[0], self.ref_kf]):
            protect[i] = k
        mask = lm_mod.redundant_keyframes(self.state, protect, self._lm_cfg())
        mask = mask.cpu().numpy()
        cand = [k for k in self.kf_order if mask[k]]
        if not cand:
            return
        posn = {k: i for i, k in enumerate(self.kf_order)}
        cov_rows = ms.covisibility(self.state)[
            torch.as_tensor(cand, device=self.device)].cpu().numpy()
        cull = []
        for j, k in enumerate(cand):
            if len(cull) >= cfg.kf_cull_max:
                break
            if any(abs(posn[k] - posn[c]) <= 1 for c in cull):
                continue
            if any(cov_rows[j][c] >= 15 for c in cull):
                continue
            cull.append(k)
        cull = self._filter_culls(cull)
        if not cull:
            return
        parents = []
        for k in cull:
            i = posn[k] - 1
            while i >= 0 and self.kf_order[i] in cull:
                i -= 1
            parents.append(self.kf_order[i] if i >= 0 else -1)
        ids = torch.as_tensor(cull + parents, device=self.device)
        Rs = self.state.kf_R[ids].cpu().numpy().astype(np.float64)
        ts_ = self.state.kf_t[ids].cpu().numpy().astype(np.float64)
        rebase = {}
        for i, (k, p) in enumerate(zip(cull, parents)):
            if p < 0:
                continue
            R_kp = Rs[i] @ Rs[len(cull) + i].T
            rebase[k] = (p, R_kp, ts_[i] - R_kp @ ts_[len(cull) + i])
        for e in self.traj:
            if e[1] in rebase:
                p, R_kp, t_kp = rebase[e[1]]
                e[2], e[3] = e[2] @ R_kp, e[2] @ t_kp + e[3]
                e[1] = p
        pad = [-1] * cfg.kf_cull_max
        pad[:len(cull)] = cull
        self._on_culled(cull)
        self.state = ms.excise_keyframes(self.state,
                                         torch.as_tensor(pad, device=self.device))
        culled = set(cull)
        self.kf_order = [k for k in self.kf_order if k not in culled]
        self._free_kf_slots.extend(sorted(culled))
