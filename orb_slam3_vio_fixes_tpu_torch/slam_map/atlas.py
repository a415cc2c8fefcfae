"""Atlas: multi-map management, map stashing on tracking loss, map merging
(port of orb_slam3_vio_fixes_tpu/slam_map/atlas.py).

A stored map is (MapState, n_kf, n_lm, BoW histograms); stashing moves the
active map's tensors aside. A merge verifies a cross-map Sim3 (descriptor
matches through kernel K2, Sim3 RANSAC and refinement, a projection count)
and writes every valid keyframe and landmark of the active map into the
stored map's free slots through the world-alignment Sim3, in one batched
scatter per field.

An inertial map's roll and pitch are fixed by gravity, so once the active
map's gravity has settled (the tracker's report) a merge of inertial maps
keeps only the yaw and the translation of the verified Sim3, at scale 1
(`AtlasConfig.inertial`), as ORB-SLAM3 forces yaw-only merges for inertial
maps after their first inertial refinement; the JAX package applies the
full Sim3.

The reference's merge sends the rows of invalid source slots to the last
destination slot and writes that slot's old value back, so a valid row that
lands on the same slot races with the pads (the winner is unspecified). The
port writes the pads through a dump slot past the end instead.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from orb_slam3_vio_fixes_tpu_torch.frontend.tracking import predict_scale
from orb_slam3_vio_fixes_tpu_torch.ops import matching
from orb_slam3_vio_fixes_tpu_torch.ops import sim3 as sim3_ops
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms
from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary as voc
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera, project


class StoredMap(NamedTuple):
    state: ms.MapState
    n_kf: int
    n_lm: int
    hists: np.ndarray    # (n_kf, W) float32 BoW keyframe histograms


class AtlasConfig(NamedTuple):
    min_stash_kfs: int = 5
    min_bow_matches: int = 20
    min_sim3_inliers: int = 15
    min_proj_matches: int = 40
    min_score: float = 0.03
    merge_window: int = 8
    n_hyp: int = 256
    fix_scale: bool = True
    inertial: bool = False      # yaw-and-translation merges of gravity-aligned maps


def verify_cross_candidate(gen: torch.Generator, cur: ms.MapState,
                           kf_id: int, old: ms.MapState, cand_id: int, cam: Camera,
                           inv_sigma2_oct, n_hyp: int, fix_scale: bool,
                           n_levels: int = 8, scale: float = 1.2):
    """Sim3 between a keyframe of the active map and a candidate keyframe of
    a stored map: mutual descriptor matches of the two keyframes' bound
    features, Sim3 RANSAC and refinement, then a 10 px projection count of the candidate's
    landmarks. Returns (n_matches, n_proj, Sim3Result), the Sim3 mapping
    candidate-camera coordinates into current-camera coordinates."""
    K, N = cur.kf_obs.shape
    L = cur.lm_pos.shape[0]
    Lo = old.lm_pos.shape[0]
    k = min(max(int(kf_id), 0), K - 1)
    c = min(max(int(cand_id), 0), old.kf_obs.shape[0] - 1)
    obs_k, obs_c = cur.kf_obs[k], old.kf_obs[c]
    lk = obs_k.to(torch.int64).clamp(0, L - 1)
    lc = obs_c.to(torch.int64).clamp(0, Lo - 1)
    has_k = (obs_k >= 0) & cur.lm_valid[lk] & cur.kf_feat_valid[k]
    has_c = (obs_c >= 0) & old.lm_valid[lc] & old.kf_feat_valid[c]
    res = matching.match_descriptors(cur.kf_desc[k], has_k, old.kf_desc[c], has_c,
                                     ratio=0.9, max_dist=matching.TH_HIGH, mutual=True)
    matched = res.idx >= 0
    j = res.idx.to(torch.int64).clamp(0, N - 1)
    pts1 = cur.lm_pos[lk] @ cur.kf_R[k].T + cur.kf_t[k]
    pts2 = old.lm_pos[obs_c[j].to(torch.int64).clamp(0, Lo - 1)] @ old.kf_R[c].T \
        + old.kf_t[c]
    nl = inv_sigma2_oct.shape[0]
    s2_k = 1.0 / inv_sigma2_oct[cur.kf_octave[k].to(torch.int64).clamp(0, nl - 1)]
    s2_c = 1.0 / inv_sigma2_oct[old.kf_octave[c][j].to(torch.int64).clamp(0, nl - 1)]
    sim = sim3_ops.sim3_ransac(gen, pts1, pts2, matched, cam, cam, s2_k, s2_c,
                               n_hyp=n_hyp, fix_scale=fix_scale)
    refined = sim3_ops.sim3_refine(sim.R, sim.t, sim.s, pts1, pts2,
                                   matched & sim.inliers, cam, cam, s2_k, s2_c,
                                   fix_scale=fix_scale)
    Xc_all = old.lm_pos[lc] @ old.kf_R[c].T + old.kf_t[c]
    Y = refined.s * (Xc_all @ refined.R.T) + refined.t
    octv = predict_scale(torch.linalg.norm(Y, dim=-1), old.lm_maxdist[lc], n_levels, scale)
    sf = float(np.float32(scale)) ** octv.to(torch.float32)
    proj = matching.search_by_projection(
        project(cam, Y), has_c & (Y[:, 2] > 0.1), old.kf_desc[c], octv, 10.0 * sf,
        cur.kf_uv[k], cur.kf_feat_valid[k], cur.kf_desc[k], cur.kf_octave[k],
        max_dist=matching.TH_HIGH, oct_window=n_levels)
    return matched.sum(), (proj.idx >= 0).sum(), refined


def merge_maps(dst: ms.MapState, src: ms.MapState, n_kf_dst: int, n_lm_dst: int,
               R_a, t_a, s_a: float) -> ms.MapState:
    """Write every valid src keyframe / landmark into dst's slots from
    (n_kf_dst, n_lm_dst) on, src world aligned into dst world by
    X_dst = s_a R_a X_src + t_a (a keyframe's SE3 becomes (R R_a^T,
    s_a t - R R_a^T t_a)). Ids are offset; returns a new dst tuple."""
    Ks = src.kf_obs.shape[0]
    Ls = src.lm_pos.shape[0]
    dev = src.kf_R.device
    Rp = src.kf_R @ R_a.T
    tp = s_a * src.kf_t - (Rp @ t_a[:, None])[..., 0]
    vel = s_a * (src.kf_vel @ R_a.T)
    Xw = s_a * (src.lm_pos @ R_a.T) + t_a
    nrm = src.lm_normal @ R_a.T
    kf_slot = torch.arange(Ks, device=dev) + int(n_kf_dst)
    lm_slot = torch.arange(Ls, device=dev) + int(n_lm_dst)
    kv, lv = src.kf_valid, src.lm_valid

    def off(ids, n):
        return torch.where(ids >= 0, ids + int(n), torch.full_like(ids, -1))

    def kw(name, value):
        return ms.set_masked(getattr(dst, name), kf_slot, kv, value)

    def lw(name, value):
        return ms.set_masked(getattr(dst, name), lm_slot, lv, value)

    dst = dst._replace(
        kf_R=kw("kf_R", Rp), kf_t=kw("kf_t", tp), kf_ts=kw("kf_ts", src.kf_ts),
        kf_vel=kw("kf_vel", vel), kf_bg=kw("kf_bg", src.kf_bg),
        kf_ba=kw("kf_ba", src.kf_ba), kf_prev=kw("kf_prev", off(src.kf_prev, n_kf_dst)),
        kf_valid=kw("kf_valid", True), kf_uv=kw("kf_uv", src.kf_uv),
        kf_ur=kw("kf_ur", src.kf_ur), kf_octave=kw("kf_octave", src.kf_octave),
        kf_angle=kw("kf_angle", src.kf_angle), kf_desc=kw("kf_desc", src.kf_desc),
        kf_feat_valid=kw("kf_feat_valid", src.kf_feat_valid),
        kf_obs=kw("kf_obs", off(src.kf_obs, n_lm_dst)),
        kf_depth=kw("kf_depth", src.kf_depth),
        lm_pos=lw("lm_pos", Xw), lm_valid=lw("lm_valid", True),
        lm_desc=lw("lm_desc", src.lm_desc), lm_normal=lw("lm_normal", nrm),
        lm_mindist=lw("lm_mindist", s_a * src.lm_mindist),
        lm_maxdist=lw("lm_maxdist", s_a * src.lm_maxdist),
        lm_first_kf=lw("lm_first_kf", off(src.lm_first_kf, n_kf_dst)),
        lm_found=lw("lm_found", src.lm_found), lm_visible=lw("lm_visible", src.lm_visible),
        epoch=dst.epoch + 1)
    return ms.update_landmark_stats(dst)


class Atlas:
    """Host-side multi-map manager: the tracker owns the active map, the
    Atlas the stored ones and the stash / merge transitions."""

    def __init__(self, map_cfg: ms.MapConfig, vocab: voc.Vocabulary, cam: Camera,
                 inv_sigma2_oct, cfg: AtlasConfig = AtlasConfig(), *, device):
        self.device = torch.device(device)
        self.map_cfg = map_cfg
        self.vocab = vocab
        self.cam = cam
        self.inv_sigma2_oct = torch.as_tensor(inv_sigma2_oct, dtype=torch.float32,
                                              device=self.device)
        self.cfg = cfg
        self.stored: List[StoredMap] = []
        self.gen = torch.Generator(device=self.device).manual_seed(23)
        self.n_merges = 0

    def stash_active(self, state: ms.MapState, n_kf: int, n_lm: int,
                     hists: np.ndarray) -> bool:
        """Keep the active map if it has at least `min_stash_kfs` keyframes."""
        if n_kf < self.cfg.min_stash_kfs:
            return False
        self.stored.append(StoredMap(state, n_kf, n_lm, np.array(hists[:n_kf])))
        return True

    def detect_merge(self, state: ms.MapState, kf_id: int):
        """(map index, candidate keyframe) of the best L1 score over every
        stored map's histograms, or None below min_score."""
        if not self.stored:
            return None
        hist = voc.bow_histogram(self.vocab, voc.assign_words(
            self.vocab, state.kf_desc[kf_id], state.kf_feat_valid[kf_id])).cpu().numpy()
        best = None
        for mi, sm in enumerate(self.stored):
            scores = 1.0 - 0.5 * np.abs(sm.hists - hist[None]).sum(-1)
            ci = int(np.argmax(scores))
            if best is None or scores[ci] > best[0]:
                best = (float(scores[ci]), mi, ci)
        if best[0] < self.cfg.min_score:
            return None
        return best[1], best[2]

    def try_merge(self, state: ms.MapState, kf_id: int, n_kf: int, n_lm: int,
                  gravity_aligned: bool = False):
        """Verify and merge the active map into a stored map; with
        `cfg.inertial` and a `gravity_aligned` active map (its IMU
        initialised and its gravity settled), the alignment keeps the Sim3's
        yaw and translation only. Returns
        (merged_state, n_kf', n_lm', kf_offset, old_hists) or None."""
        cand = self.detect_merge(state, kf_id)
        if cand is None:
            return None
        mi, ci = cand
        sm = self.stored[mi]
        mc = self.map_cfg
        if sm.n_kf + n_kf > mc.max_keyframes or sm.n_lm + n_lm > mc.max_landmarks:
            return None
        Kd, Nd = sm.state.kf_obs.shape
        Ld = sm.state.lm_pos.shape[0]
        if (Kd, Ld) != (mc.max_keyframes, mc.max_landmarks):
            old_cfg = ms.MapConfig(Kd, Ld, Nd, mc.n_levels, mc.scale)
            sm = sm._replace(state=ms.grow_map(sm.state, old_cfg, mc))
            self.stored[mi] = sm
        n_m, n_proj, sim = verify_cross_candidate(
            self.gen, state, kf_id, sm.state, ci, self.cam, self.inv_sigma2_oct,
            self.cfg.n_hyp, self.cfg.fix_scale, n_levels=mc.n_levels, scale=mc.scale)
        gates = torch.stack([n_m.to(torch.float32), n_proj.to(torch.float32),
                             sim.n_inliers.to(torch.float32)]).cpu().numpy()
        if (int(gates[0]) < self.cfg.min_bow_matches
                or int(gates[2]) < self.cfg.min_sim3_inliers
                or int(gates[1]) < self.cfg.min_proj_matches):
            return None
        # active world -> stored world: T_wc(cand) o sim^-1 o T_cw(cur)
        R_s, t_s = sim.R.cpu().numpy(), sim.t.cpu().numpy()
        s_s = float(sim.s)
        R_cur, t_cur = state.kf_R[kf_id].cpu().numpy(), state.kf_t[kf_id].cpu().numpy()
        R_cand, t_cand = sm.state.kf_R[ci].cpu().numpy(), sm.state.kf_t[ci].cpu().numpy()
        if self.cfg.inertial and gravity_aligned:
            R_s, t_s = sim3_ops.yaw_only(R_s, t_s, R_cur, t_cur, R_cand, t_cand)
            s_s = 1.0
        Rw = R_cand.T @ R_s.T @ R_cur
        tw = R_cand.T @ ((1.0 / s_s) * R_s.T @ (t_cur - t_s)) - R_cand.T @ t_cand
        merged = merge_maps(sm.state, state, sm.n_kf, sm.n_lm,
                            torch.as_tensor(Rw, dtype=torch.float32, device=self.device),
                            torch.as_tensor(tw, dtype=torch.float32, device=self.device),
                            float(np.float32(1.0 / s_s)))
        self.stored.pop(mi)
        self.n_merges += 1
        return merged, sm.n_kf + n_kf, sm.n_lm + n_lm, sm.n_kf, sm.hists
