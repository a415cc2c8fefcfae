"""Relocalisation: BoW candidate retrieval, batched PnP RANSAC and pose
refinement (port of orb_slam3_vio_fixes_tpu/frontend/relocalization.py).

The candidate loop stays on the host (a few candidates); each attempt is a
mutual descriptor match through kernel K2, ML-PnP RANSAC, motion-only pose
optimisation, a local-map widening over the candidate's covisible window,
and a second optimisation; success needs 50 inliers. With a `parallel.Mesh`
the relocaliser first tries a whole-map search: the frame bound to the
landmark table row-sharded over the mesh (one K2 launch per shard), then
the same PnP, optimisation and widening, before the BoW candidates.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam3_vio_fixes_tpu_torch.frontend import tracking as trk
from orb_slam3_vio_fixes_tpu_torch.frontend.frame import FrameData
from orb_slam3_vio_fixes_tpu_torch.ops import matching, pnp
from orb_slam3_vio_fixes_tpu_torch.runtime import tracing
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms
from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary as voc
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera


class RelocConfig(NamedTuple):
    min_bow_matches: int = 15
    min_pnp_inliers: int = 10
    accept_inliers: int = 50
    n_hyp: int = 256
    n_candidates: int = 3


def reloc_attempt(gen, state: ms.MapState, cand_id: int, frame: FrameData,
                  window_kfs, cam: Camera, bf: float, cfg: RelocConfig,
                  tcfg: trk.TrackerConfig):
    """One candidate: frame features matched to the candidate's
    landmark-bound features, PnP RANSAC, pose optimisation, local-window widening at radius
    factor 2, final optimisation. Returns device tensors (ok, R, t, cur_obs,
    n_inliers, n_bow)."""
    K, N = state.kf_obs.shape
    L = state.lm_pos.shape[0]
    c = min(max(int(cand_id), 0), K - 1)
    obs_c = state.kf_obs[c]
    lc = obs_c.to(torch.int64).clamp(0, L - 1)
    has_c = (obs_c >= 0) & state.lm_valid[lc] & state.kf_feat_valid[c]
    res = matching.match_descriptors(frame.desc, frame.valid, state.kf_desc[c], has_c,
                                     ratio=0.75, max_dist=matching.TH_LOW, mutual=True)
    matched = res.idx >= 0
    n_bow = matched.sum()
    j = res.idx.to(torch.int64).clamp(0, N - 1)
    lm_ids = torch.where(matched, obs_c[j], torch.full_like(obs_c, -1))
    X = state.lm_pos[lm_ids.to(torch.int64).clamp(0, L - 1)]
    n_lv = tcfg.orb.n_levels
    inv_s2 = trk.octave_inv_sigma2(tcfg.orb, X.device)[
        frame.octave.to(torch.int64).clamp(0, n_lv - 1)]
    pr = pnp.pnp_ransac(gen, X, frame.uv, matched, inv_s2, cam, n_hyp=cfg.n_hyp,
                        min_inliers=cfg.min_pnp_inliers)
    cur_obs = torch.where(matched & pr.inliers, lm_ids, torch.full_like(lm_ids, -1))
    R1, t1, cur_obs, _ = trk.pose_opt_from_obs(state, pr.R, pr.t, frame, cur_obs,
                                               cam, bf, tcfg)
    R2, t2, cur_obs, n2 = trk.track_local_map(state, R1, t1, frame, cur_obs,
                                              window_kfs, cam, bf, 2.0, tcfg)
    ok = pr.success & (n_bow >= cfg.min_bow_matches) & (n2 >= cfg.accept_inliers)
    return ok, R2, t2, cur_obs, n2, n_bow


class Relocalizer:
    """Queries the keyframe database shared with the loop closer (`db_ref`
    returns the live one) and tries candidates until one verifies."""

    def __init__(self, vocab: voc.Vocabulary, db_ref, cfg: RelocConfig = RelocConfig(),
                 mesh=None, *, device):
        """mesh: an optional `parallel.Mesh`; its axis "db" (else its only
        axis) shards the landmark table for the whole-map search."""
        self.device = torch.device(device)
        self.vocab = vocab
        self.db_ref = db_ref
        self.cfg = cfg
        self.mesh = mesh
        self.gen = torch.Generator(device=self.device).manual_seed(13)
        self.n_success = 0
        self.n_success_global = 0

    def candidates(self, state: ms.MapState, frame: FrameData):
        hist = voc.bow_histogram(self.vocab,
                                 voc.assign_words(self.vocab, frame.desc, frame.valid))
        ids, _ = voc.db_query(self.db_ref(), hist, ~state.kf_valid, 0.0,
                              n_best=self.cfg.n_candidates)
        return [int(i) for i in ids.cpu().numpy() if i >= 0]

    def _relocalize_global(self, state: ms.MapState, frame: FrameData, cam: Camera,
                           bf: float, tcfg: trk.TrackerConfig):
        """The mesh path: one sharded whole-map descriptor search binds the
        frame's features to landmarks, then PnP RANSAC, pose optimisation
        and a widening over the keyframes that anchor the inlier landmarks.
        Returns (R, t, cur_obs, n_inliers) or None."""
        from orb_slam3_vio_fixes_tpu_torch.parallel import sharded_matching as sm

        L = state.lm_desc.shape[0]
        axis = "db" if "db" in self.mesh.shape else self.mesh.axis_names[0]
        if L % self.mesh.shape[axis]:
            return None     # capacity tiers are powers of two
        lm_ids = sm.sharded_global_bind(frame.desc, frame.valid, state.lm_desc,
                                        state.lm_valid, self.mesh, axis=axis)
        matched = lm_ids >= 0
        if int(matched.sum()) < self.cfg.min_bow_matches:
            return None
        safe = lm_ids.to(torch.int64).clamp(0, L - 1)
        n_lv = tcfg.orb.n_levels
        inv_s2 = trk.octave_inv_sigma2(tcfg.orb, self.device)[
            frame.octave.to(torch.int64).clamp(0, n_lv - 1)]
        pr = pnp.pnp_ransac(self.gen, state.lm_pos[safe], frame.uv, matched, inv_s2, cam,
                            n_hyp=self.cfg.n_hyp, min_inliers=self.cfg.min_pnp_inliers)
        if not bool(pr.success):
            return None
        cur_obs = torch.where(matched & pr.inliers, lm_ids, torch.full_like(lm_ids, -1))
        R1, t1, cur_obs, _ = trk.pose_opt_from_obs(state, pr.R, pr.t, frame, cur_obs,
                                                   cam, bf, tcfg)
        # the local window: the keyframes that first saw the most inliers
        anchors = state.lm_first_kf[safe].cpu().numpy()[cur_obs.cpu().numpy() >= 0]
        W = tcfg.ba_window + tcfg.ba_fixed
        top = np.full(W, -1, np.int64)
        if anchors.size:
            uniq, counts = np.unique(anchors[anchors >= 0], return_counts=True)
            sel = uniq[np.argsort(-counts)][:W]
            top[:len(sel)] = sel
        R2, t2, cur_obs, n2 = trk.track_local_map(
            state, R1, t1, frame, cur_obs, torch.as_tensor(top, device=self.device), cam,
            bf, 2.0, tcfg)
        n2 = int(n2)
        if n2 < self.cfg.accept_inliers:
            return None
        self.n_success += 1
        self.n_success_global += 1
        return R2, t2, cur_obs, n2

    def relocalize(self, state: ms.MapState, frame: FrameData, cam: Camera, bf: float,
                   tcfg: trk.TrackerConfig):
        """(R, t, cur_obs, n_inliers) or None: the whole-map search first when
        a mesh is set, then the BoW candidates, one pull per candidate."""
        with tracing.span("reloc"):
            if self.mesh is not None:
                hit = self._relocalize_global(state, frame, cam, bf, tcfg)
                if hit is not None:
                    return hit
            cov = None
            W = tcfg.ba_window + tcfg.ba_fixed
            for cand in self.candidates(state, frame):
                if cov is None:
                    cov = ms.covisibility(state).cpu().numpy()
                row = cov[cand].copy()
                row[cand] = row.max() + 1
                top = np.argsort(-row)[:W]
                top = np.where(row[top] > 0, top, -1)
                ok, R, t, cur_obs, n_inl, _ = reloc_attempt(
                    self.gen, state, cand, frame, torch.as_tensor(top, device=self.device),
                    cam, bf, self.cfg, tcfg)
                ok_n = torch.stack([ok.to(torch.int64), n_inl.to(torch.int64)]).cpu().numpy()
                if ok_n[0]:
                    self.n_success += 1
                    return R, t, cur_obs, int(ok_n[1])
            return None
