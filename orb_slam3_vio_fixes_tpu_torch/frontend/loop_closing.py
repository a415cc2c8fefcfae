"""Loop closing: place recognition, Sim3 verification, pose-graph correction
(port of orb_slam3_vio_fixes_tpu/frontend/loop_closing.py).

Retrieval is one masked top-k over the dense (K, W) BoW database with
covisibility-group accumulation (slam_map/vocabulary.py); a candidate is
verified by prior-guided and appearance matching (both through kernel K2),
batched Sim3 RANSAC, Gauss-Newton Sim3 refinement and a strict projection
count; a correction fires only after `n_consistency` consecutive keyframes
verify the same region, then runs the essential-graph optimisation, moves
every landmark through its anchor keyframe's correction, and (small maps)
a global BA. The randomness of the RANSAC comes from an explicit
`torch.Generator`. The multi-device global BA of the reference (`mesh`) is
not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam3_vio_fixes_tpu_torch.frontend.tracking import predict_scale
from orb_slam3_vio_fixes_tpu_torch.ops import matching
from orb_slam3_vio_fixes_tpu_torch.ops import sim3 as sim3_ops
from orb_slam3_vio_fixes_tpu_torch.optim import global_ba as gba_mod
from orb_slam3_vio_fixes_tpu_torch.optim import pose_graph as pg
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms
from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary as voc
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera, project, unproject


class LoopConfig(NamedTuple):
    min_bow_matches: int = 20
    min_sim3_inliers: int = 15
    min_refine_inliers: int = 20
    min_proj_matches: int = 30
    guided_radius: float = 40.0
    verify_radius: float = 10.0
    proj_max_dist: int = 80
    min_gap_kfs: int = 10
    min_score: float = 0.03
    n_candidates: int = 3
    n_consistency: int = 3
    n_hyp: int = 256
    fix_scale: bool = True
    max_edges: int = 2048
    pg_iters: int = 12
    run_gba: bool = True
    gba_max_kf: int = 200
    inertial: bool = False
    scale_gate: float = 0.1


def kf_histogram(vocab: voc.Vocabulary, desc, feat_valid):
    return voc.bow_histogram(vocab, voc.assign_words(vocab, desc, feat_valid))


def verify_candidate(gen: torch.Generator, state: ms.MapState,
                     kf_id: int, cand_id: int, cam: Camera, inv_sigma2_oct,
                     n_hyp: int, fix_scale: bool, n_levels: int = 8,
                     scale: float = 1.2, guided_radius: float = 40.0,
                     verify_radius: float = 8.0, proj_max_dist: int = 64):
    """Geometric verification of one same-map loop candidate: prior-guided
    window matches united with mutual appearance matches, Sim3 RANSAC on
    the pairs with 3D on both sides, Gauss-Newton refinement, and a strict
    projection count through the refined Sim3. Returns (n_matches, n_ransac_inliers,
    n_proj, Sim3Result) as device tensors; the Sim3 maps candidate-camera
    coordinates into current-camera coordinates."""
    K, N = state.kf_obs.shape
    L = state.lm_pos.shape[0]
    k = min(max(int(kf_id), 0), K - 1)
    c = min(max(int(cand_id), 0), K - 1)
    obs_k, obs_c = state.kf_obs[k], state.kf_obs[c]
    lc = obs_c.to(torch.int64).clamp(0, L - 1)
    has_c = (obs_c >= 0) & state.lm_valid[lc] & state.kf_feat_valid[c]
    R_k, t_k = state.kf_R[k], state.kf_t[k]
    R_c, t_c = state.kf_R[c], state.kf_t[c]
    Xc_cam = state.lm_pos[lc] @ R_c.T + t_c          # candidate camera frame
    desc_c = state.lm_desc[lc]
    maxdist_c = state.lm_maxdist[lc]

    def project_and_match(Rs, ts, ss, radius_px):
        Y = ss * (Xc_cam @ Rs.T) + ts
        octv = predict_scale(torch.linalg.norm(Y, dim=-1), maxdist_c, n_levels, scale)
        sf = float(np.float32(scale)) ** octv.to(torch.float32)
        return matching.search_by_projection(
            project(cam, Y), has_c & (Y[:, 2] > 0.1), desc_c, octv,
            radius_px * sf, state.kf_uv[k], state.kf_feat_valid[k],
            state.kf_desc[k], state.kf_octave[k], max_dist=proj_max_dist,
            oct_window=n_levels)

    R0 = R_k @ R_c.T
    guided = project_and_match(R0, t_k - R0 @ t_c, 1.0, guided_radius)
    app = matching.match_descriptors(
        state.kf_desc[c], has_c, state.kf_desc[k], state.kf_feat_valid[k],
        angle_q=state.kf_angle[c], angle_t=state.kf_angle[k], ratio=0.75,
        max_dist=matching.TH_LOW, check_rotation=True, mutual=True)
    st1_idx = torch.where(guided.idx >= 0, guided.idx, app.idx)
    g_ok = st1_idx >= 0
    n_guided = g_ok.sum()

    gj = st1_idx.to(torch.int64).clamp(0, N - 1)
    cur_lm = obs_k[gj].to(torch.int64)
    cur_l = cur_lm.clamp(0, L - 1)
    cur_bound = (cur_lm >= 0) & state.lm_valid[cur_l]
    X_cur_lm = state.lm_pos[cur_l] @ R_k.T + t_k
    z_k = state.kf_depth[k][gj]
    X_cur_st = unproject(cam, state.kf_uv[k][gj]) * torch.clamp(z_k, min=1e-6)[:, None]
    pts1 = torch.where(cur_bound[:, None], X_cur_lm, X_cur_st)
    pair_ok = g_ok & (cur_bound | (z_k > 0))
    n_oct = inv_sigma2_oct.shape[0]
    s2_k = 1.0 / inv_sigma2_oct[state.kf_octave[k][gj].to(torch.int64).clamp(0, n_oct - 1)]
    s2_c = 1.0 / inv_sigma2_oct[state.kf_octave[c].to(torch.int64).clamp(0, n_oct - 1)]
    sim = sim3_ops.sim3_ransac(gen, pts1, Xc_cam, pair_ok, cam, cam, s2_k, s2_c,
                               n_hyp=n_hyp, fix_scale=fix_scale)
    refined = sim3_ops.sim3_refine(sim.R, sim.t, sim.s, pts1, Xc_cam,
                                   pair_ok & sim.inliers, cam, cam, s2_k, s2_c,
                                   fix_scale=fix_scale)
    proj = project_and_match(refined.R, refined.t, refined.s, verify_radius)
    return n_guided, sim.n_inliers, (proj.idx >= 0).sum(), refined


def detect_candidates(db: voc.KeyFrameDatabase, state: ms.MapState, hist,
                      kf_id: int, recent_slots, min_score: float, n_best: int):
    """Covisibility-group BoW retrieval with the query's covisible, recent
    (recent_slots, -1 padded) and invalid keyframes excluded."""
    cov = ms.covisibility(state)
    K = cov.shape[0]
    recent = torch.as_tensor(np.asarray(recent_slots, np.int64), device=cov.device)
    recent_mask = ms.set_masked(torch.zeros(K, dtype=torch.bool, device=cov.device),
                                recent.clamp(0, K - 1), recent >= 0, True)
    exclude = (cov[int(kf_id)] > 0) | recent_mask | ~state.kf_valid
    exclude[int(kf_id)] = True
    return voc.db_query_grouped(db, hist, cov.to(torch.float32), exclude,
                                min_score, n_best=n_best)


def apply_correction(state: ms.MapState, R_new, t_new, s_new, n_levels: int = 8,
                     scale: float = 1.2) -> ms.MapState:
    """Write the corrected keyframe poses (stored as the SE3 (R, t/s)) and
    move every anchored landmark through its anchor keyframe: old camera
    frame, then the corrected Sim3's inverse. Velocities follow the same
    per-keyframe linear correction. Every write is an elementwise select,
    so no pad index can race a real one. Returns a new state tuple."""
    K = state.kf_R.shape[0]
    anchor = state.lm_first_kf.to(torch.int64).clamp(0, K - 1)
    anchored = (state.lm_first_kf >= 0) & state.lm_valid & state.kf_valid[anchor]
    Xc = (state.kf_R[anchor] @ state.lm_pos[..., None])[..., 0] + state.kf_t[anchor]
    sn = torch.clamp(s_new, min=1e-9)
    Xw = (R_new[anchor].transpose(1, 2) @ (Xc - t_new[anchor])[..., None])[..., 0] \
        / sn[anchor][:, None]
    v_cam = (state.kf_R @ state.kf_vel[..., None])[..., 0]
    v_new = (R_new.transpose(1, 2) @ v_cam[..., None])[..., 0] / sn[:, None]
    kv = state.kf_valid
    state = state._replace(
        kf_R=torch.where(kv[:, None, None], R_new, state.kf_R),
        kf_t=torch.where(kv[:, None], t_new / sn[:, None], state.kf_t),
        kf_vel=torch.where(kv[:, None], v_new, state.kf_vel),
        lm_pos=torch.where(anchored[:, None], Xw, state.lm_pos),
        epoch=state.epoch + 1)
    return ms.update_landmark_stats(state, n_levels, scale)


class LoopResult(NamedTuple):
    cand_id: int
    n_matches: int
    n_inliers: int
    corrected: bool
    n_proj: int = 0


class LoopCloser:
    """Host orchestrator for place recognition and loop correction: owns the
    vocabulary and the (K, W) keyframe database; `on_keyframe` runs after
    each keyframe insertion (sync mode)."""

    def __init__(self, vocab: voc.Vocabulary, cam: Camera, max_kf: int,
                 inv_sigma2_oct, cfg: LoopConfig = LoopConfig(), bf: float = 0.0,
                 n_levels: int = 8, scale: float = 1.2, mesh=None, *, device):
        if mesh is not None:
            raise NotImplementedError("the multi-device global BA is not ported")
        self.device = torch.device(device)
        self.vocab = vocab
        self.cam = cam
        self.cfg = cfg
        self.bf = float(np.float32(bf))
        self.n_levels = n_levels
        self.scale = scale
        self.db = voc.KeyFrameDatabase.empty(max_kf, vocab.n_words, self.device)
        self.inv_sigma2_oct = torch.as_tensor(inv_sigma2_oct, dtype=torch.float32,
                                              device=self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(7)
        self.loop_edges = []
        self.n_corrections = 0
        self.hits = []
        self.max_hits = 256
        self._pending_group = None
        self._pending_count = 0

    def reset(self):
        """Clear the database and the consistency chain (the active map was
        stashed: keyframe slot ids restart). A new table: the stashed map may
        still hold the old one's rows."""
        K, W = self.db.hist.shape
        self.db = voc.KeyFrameDatabase.empty(K, W, self.device)
        self._pending_group = None
        self._pending_count = 0

    def grow(self, max_kf: int):
        K, W = self.db.hist.shape
        if max_kf <= K:
            return
        h = torch.zeros((max_kf, W), device=self.device)
        h[:K] = self.db.hist
        self.db = voc.KeyFrameDatabase(h)

    def rebuild_after_merge(self, old_hists: np.ndarray, kf_off: int, n_cur: int):
        """Stored-map rows keep ids [0, kf_off), active-map rows move to
        [kf_off, kf_off + n_cur)."""
        K, W = self.db.hist.shape
        h = torch.zeros((K, W), device=self.device)
        m = min(kf_off, K)
        h[:m] = torch.as_tensor(np.asarray(old_hists[:m], np.float32), device=self.device)
        h[kf_off:kf_off + n_cur] = self.db.hist[:n_cur]
        self.db = voc.KeyFrameDatabase(h)
        self._pending_group = None
        self._pending_count = 0

    def add_keyframe(self, state: ms.MapState, kf_id: int):
        hist = kf_histogram(self.vocab, state.kf_desc[kf_id], state.kf_feat_valid[kf_id])
        voc.db_add(self.db, kf_id, hist)
        return hist

    def detect(self, state: ms.MapState, kf_id: int, hist, recent_slots=None):
        """Candidate slots (host list): one device query, one small pull."""
        cfg = self.cfg
        if recent_slots is None:
            recent_slots = [kf_id - i for i in range(cfg.min_gap_kfs)]
        rs = np.full(cfg.min_gap_kfs, -1, np.int64)
        for i, s in enumerate(list(recent_slots)[-cfg.min_gap_kfs:]):
            rs[i] = s
        ids, _ = detect_candidates(self.db, state, hist, kf_id, rs, cfg.min_score,
                                   cfg.n_candidates)
        return [int(i) for i in ids.cpu().numpy() if i >= 0]

    def on_keyframe(self, state: ms.MapState, kf_id: int, n_kf: int,
                    recent_slots=None):
        """Histogram, retrieval, verification of each candidate (one pull of
        its gate scalars), the temporal-consistency gate, and the correction.
        Returns (state, LoopResult or None)."""
        cfg = self.cfg
        hist = self.add_keyframe(state, kf_id)
        hit = None
        for cand in self.detect(state, kf_id, hist, recent_slots=recent_slots):
            n_m, n_ransac, n_proj, sim = verify_candidate(
                self.gen, state, kf_id, cand, self.cam, self.inv_sigma2_oct, cfg.n_hyp,
                cfg.fix_scale, n_levels=self.n_levels, scale=self.scale,
                guided_radius=cfg.guided_radius, verify_radius=cfg.verify_radius,
                proj_max_dist=cfg.proj_max_dist)
            gates = torch.stack([n_m.to(torch.float32), n_ransac.to(torch.float32),
                                 n_proj.to(torch.float32),
                                 sim.n_inliers.to(torch.float32),
                                 sim.s.to(torch.float32)]).cpu().numpy()
            n_m, n_ransac, n_proj, n_ref = (int(x) for x in gates[:4])
            if (n_m < cfg.min_bow_matches or n_ransac < cfg.min_sim3_inliers
                    or n_ref < cfg.min_refine_inliers
                    or n_proj < cfg.min_proj_matches):
                continue
            if cfg.inertial and abs(float(gates[4]) - 1.0) > cfg.scale_gate:
                continue
            self.hits.append(dict(kf=kf_id, cand=cand, n_m=n_m, n_ransac=n_ransac,
                                  n_proj=n_proj, n_ref=n_ref))
            del self.hits[:-self.max_hits]
            hit = (cand, n_m, n_ref, n_proj, sim)
            break
        if hit is None:
            self._pending_group = None
            self._pending_count = 0
            return state, None
        cand, n_m, n_ref, n_proj, sim = hit
        group = self._covisible_group(state, cand)
        if self._pending_group is not None and self._pending_group & group:
            self._pending_count += 1
        else:
            self._pending_count = 1
        self._pending_group = group
        if self._pending_count < cfg.n_consistency:
            return state, LoopResult(cand, n_m, n_ref, False, n_proj)
        self._pending_group = None
        self._pending_count = 0
        state = self._correct(state, kf_id, cand, sim, n_kf)
        self.n_corrections += 1
        return state, LoopResult(cand, n_m, n_ref, True, n_proj)

    def _covisible_group(self, state: ms.MapState, cand: int):
        row = ms.covisibility(state)[cand].cpu().numpy()
        group = {int(i) for i in np.nonzero(row >= 15)[0]}
        group.add(int(cand))
        return group

    def _yaw_only(self, state: ms.MapState, kf_id: int, cand: int, sim):
        """Inertial maps: keep only the yaw of the measured loop transform's
        discrepancy from the odometric relative pose (roll and pitch are
        observable through gravity)."""
        pose = [x.cpu().numpy() for x in (sim.R, sim.t, state.kf_R[kf_id], state.kf_t[kf_id],
                                          state.kf_R[cand], state.kf_t[cand])]
        R, t = sim3_ops.yaw_only(*pose)
        dev = self.device
        return (torch.as_tensor(R, dtype=torch.float32, device=dev),
                torch.as_tensor(t, dtype=torch.float32, device=dev),
                torch.ones((), device=dev))

    def _correct(self, state: ms.MapState, kf_id: int, cand: int,
                 sim: sim3_ops.Sim3Result, n_kf: int):
        """Essential graph with the loop edge S_cur_cand (the loop keyframe and
        keyframe 0 fixed), landmark correction, then global BA on small
        maps."""
        cfg = self.cfg
        K = state.kf_R.shape[0]
        edges = pg.essential_edges_from_map(
            state.kf_R.cpu().numpy(), state.kf_t.cpu().numpy(),
            state.kf_valid.cpu().numpy(), state.kf_prev.cpu().numpy(),
            ms.covisibility(state).cpu().numpy(), cfg.max_edges,
            cov_threshold=100, device=self.device)
        sim_R, sim_t, sim_s = sim.R, sim.t, sim.s
        if cfg.inertial:
            sim_R, sim_t, sim_s = self._yaw_only(state, kf_id, cand, sim)
        n_valid = int(edges.valid.sum())
        pg.add_loop_edge(edges, n_valid, cand, kf_id, sim_R, sim_t, sim_s, weight=100.0)
        # the pad edges weigh 0 and add exact zeros: leave them out
        edges = pg.PoseGraphEdges(*(f[:n_valid + 1] for f in edges))
        self.loop_edges.append((cand, kf_id, (sim_R.cpu().numpy(), sim_t.cpu().numpy(),
                                              float(sim_s))))
        fixed = torch.zeros(K, dtype=torch.bool, device=self.device)
        fixed[cand] = True
        fixed[0] = True
        R, t, s, _ = pg.optimize_pose_graph(
            state.kf_R, state.kf_t, torch.ones(K, device=self.device), fixed, edges,
            pg.PoseGraphConfig(n_iters=cfg.pg_iters, fix_scale=cfg.fix_scale,
                               four_dof=cfg.inertial))
        state = apply_correction(state, R, t, s, n_levels=self.n_levels,
                                 scale=self.scale)
        if cfg.run_gba and n_kf <= cfg.gba_max_kf:
            state, _ = gba_mod.run_global_ba(
                state, self.inv_sigma2_oct, self.cam, self.bf, 0,
                n_levels=self.n_levels, scale=self.scale)
        return state
