"""Local mapping: new-landmark triangulation, duplicate fusion, culling (port
of orb_slam3_vio_fixes_tpu/frontend/local_mapping.py).

The map is updated in place (see slam_map/map_state.py). Pad indices never
share a scatter target with a real write: rows that must not be written go
to a dump slot past the end of the row, or carry the slot's own value.
"""

from __future__ import annotations

import math

import torch

from orb_slam3_vio_fixes_tpu_torch.ops import image as image_ops
from orb_slam3_vio_fixes_tpu_torch.ops import matching
from orb_slam3_vio_fixes_tpu_torch.ops.triangulate import (
    triangulate_dlt, triangulation_checks)
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import (
    Camera, in_image, k_inv, project, unproject)


def _epipolar_mask(cam: Camera, R1, t1, R2, t2, uv1, uv2, sigma2_2):
    """Squared epipolar-line distance in image 2 < 3.84 sigma2."""
    R21 = R2 @ R1.T
    t21 = t2 - R21 @ t1
    z = torch.zeros((), device=R1.device)
    tx = torch.stack([torch.stack([z, -t21[2], t21[1]]),
                      torch.stack([t21[2], z, -t21[0]]),
                      torch.stack([-t21[1], t21[0], z])])
    Kinv = k_inv(cam, R1.device)
    Fm = Kinv.T @ (tx @ R21) @ Kinv
    ones1 = torch.ones((uv1.shape[0], 1), dtype=uv1.dtype, device=uv1.device)
    lines = torch.cat([uv1, ones1], dim=-1) @ Fm.T
    ones2 = torch.ones((uv2.shape[0], 1), dtype=uv2.dtype, device=uv2.device)
    num = (lines @ torch.cat([uv2, ones2], dim=-1).T) ** 2
    den = lines[:, 0:1] ** 2 + lines[:, 1:2] ** 2
    return num / torch.clamp(den, min=1e-12) < 3.84 * sigma2_2[None, :]


class LocalMapConfig:
    """Static knobs (hashable, like the reference)."""

    def __init__(self, n_neighbors=4, new_lm_budget=512, n_levels=8, scale=1.2,
                 width=752, height=480, cull_min_obs=2, cull_grace_kfs=2,
                 fuse_radius=3.0, kf_cull_redundancy=0.9):
        self.n_neighbors = n_neighbors
        self.new_lm_budget = new_lm_budget
        self.n_levels = n_levels
        self.scale = scale
        self.width = width
        self.height = height
        self.cull_min_obs = cull_min_obs
        self.cull_grace_kfs = cull_grace_kfs
        self.fuse_radius = fuse_radius
        self.kf_cull_redundancy = kf_cull_redundancy

    def _key(self):
        return (self.n_neighbors, self.new_lm_budget, self.n_levels, self.scale,
                self.width, self.height, self.cull_min_obs, self.cull_grace_kfs,
                self.fuse_radius, self.kf_cull_redundancy)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, LocalMapConfig) and self._key() == other._key()


def create_new_landmarks_impl(state: ms.MapState, kf_id: int, neighbor_ids,
                              n_lm, cam: Camera, bf: float,
                              cfg: LocalMapConfig):
    """Triangulate new landmarks between the new keyframe and each neighbour
    in turn (later passes see only still-unbound features).

    neighbor_ids: sequence of int slots (-1 pad). Returns (state, n_created
    as a 0-dim tensor)."""
    K, N = state.kf_obs.shape
    L = state.lm_pos.shape[0]
    dev = state.kf_obs.device
    sf = image_ops.scale_factors(cfg.n_levels, cfg.scale, device=dev)
    s2 = sf * sf
    k = min(max(int(kf_id), 0), K - 1)
    R1, t1 = state.kf_R[k].clone(), state.kf_t[k].clone()
    uv1 = state.kf_uv[k]
    desc1 = state.kf_desc[k]
    oct1 = state.kf_octave[k]
    fv1 = state.kf_feat_valid[k]
    baseline = bf / cam.fx
    n0 = n_lm                           # an int or a 0-dim device tensor
    C1 = -R1.T @ t1
    ray1 = unproject(cam, uv1)
    o1 = oct1.to(torch.int64).clamp(0, cfg.n_levels - 1)
    for nb in list(neighbor_ids)[:cfg.n_neighbors]:
        nb = int(nb)
        n = min(max(nb, 0), K - 1)
        nb_ok = state.kf_valid[n] & (nb >= 0)
        R2, t2 = state.kf_R[n], state.kf_t[n]
        uv2 = state.kf_uv[n]
        desc2 = state.kf_desc[n]
        oct2 = state.kf_octave[n]
        C2 = -R2.T @ t2
        base_ok = torch.linalg.norm(C2 - C1) > baseline
        epi = _epipolar_mask(cam, R1, t1, R2, t2, uv1, uv2,
                             s2[oct2.to(torch.int64).clamp(0, cfg.n_levels - 1)])
        free1 = fv1 & (state.kf_obs[k] < 0)
        free2 = state.kf_feat_valid[n] & (state.kf_obs[n] < 0)
        mask = epi & free1[:, None] & free2[None, :] & nb_ok & base_ok
        best_idx, best, _, _ = matching.hamming_best2(desc1, desc2, mask)
        ok = best <= matching.TH_LOW
        ok &= matching.mutual_ok(desc1, desc2, mask, best_idx)

        j = best_idx.to(torch.int64).clamp(0, N - 1)
        R1b, t1b = R1.expand(N, 3, 3), t1.expand(N, 3)
        R2b, t2b = R2.expand(N, 3, 3), t2.expand(N, 3)
        Xw = triangulate_dlt(R1b, t1b, R2b, t2b, ray1, unproject(cam, uv2[j]))
        good = triangulation_checks(cam, R1b, t1b, R2b, t2b, uv1, uv2[j], Xw,
                                    oct1, oct2[j], sf, s2)
        is_new = ok & good
        slot_off = torch.cumsum(is_new.to(torch.int64), 0) - 1
        is_new &= (slot_off < cfg.new_lm_budget) & ((n_lm + slot_off) < (L - 1))
        slots = torch.where(is_new, n_lm + slot_off, torch.full_like(slot_off, L - 1))

        d = Xw - C1[None]
        dn = torch.linalg.norm(d, dim=-1)
        normal = d / torch.clamp(dn[:, None], min=1e-9)
        maxdist = dn * sf[o1]
        state = ms.add_landmarks(state, slots, Xw, desc1, normal,
                                 maxdist / sf[-1], maxdist, kf_id, is_new)
        # bind the observations in both keyframes
        state.kf_obs[k] = torch.where(is_new, slots.to(torch.int32), state.kf_obs[k])
        state.kf_obs[n] = torch.where(nb_ok, ms.set_masked(
            state.kf_obs[n], j, is_new, slots.to(torch.int32)), state.kf_obs[n])
        n_lm = n_lm + is_new.sum()
    return state._replace(epoch=state.epoch + 1), n_lm - n0


def fuse_duplicates_impl(state: ms.MapState, kf_id: int, neighbor_ids,
                         cam: Camera, cfg: LocalMapConfig) -> ms.MapState:
    """Project the new keyframe's landmarks into each neighbour; a match bound
    to a different landmark is a duplicate (merged into the smaller id by one
    relabel of the observation table); a match on a free feature binds it.

    Where several duplicates of one pass name the same larger id, the
    smallest partner wins (the reference's scatter leaves that winner
    unspecified)."""
    K, N = state.kf_obs.shape
    L = state.lm_pos.shape[0]
    dev = state.kf_obs.device
    sf = image_ops.scale_factors(cfg.n_levels, cfg.scale, device=dev)
    k = min(max(int(kf_id), 0), K - 1)
    obs_k = state.kf_obs[k].clone()
    lm_ids = obs_k.to(torch.int64).clamp(0, L - 1)
    has = (obs_k >= 0) & state.lm_valid[lm_ids] & state.kf_feat_valid[k]
    X = state.lm_pos[lm_ids]
    desc = state.lm_desc[lm_ids]
    mind = state.lm_mindist[lm_ids]
    maxd = state.lm_maxdist[lm_ids]
    remap = torch.arange(L, dtype=torch.int64, device=dev)
    lm_valid = state.lm_valid.clone()
    log_scale = math.log(cfg.scale)

    for nb in list(neighbor_ids)[:cfg.n_neighbors]:
        nb = int(nb)
        n = min(max(nb, 0), K - 1)
        nb_ok = state.kf_valid[n] & (nb >= 0)
        Rn, tn = state.kf_R[n], state.kf_t[n]
        Xc = X @ Rn.T + tn
        uvp = project(cam, Xc)
        Cn = -Rn.T @ tn
        dist = torch.linalg.norm(X - Cn[None], dim=-1)
        vis = has & nb_ok & (Xc[:, 2] > 0) & in_image(uvp, cfg.width, cfg.height)
        vis &= (dist >= 0.8 * mind) & (dist <= 1.2 * maxd)
        ratio = torch.clamp(maxd / torch.clamp(dist, min=1e-9), min=1e-9)
        octv = torch.clamp(torch.ceil(torch.log(ratio) / log_scale).to(torch.int32),
                           0, cfg.n_levels - 1)
        radius = cfg.fuse_radius * sf[octv.to(torch.int64)]
        res = matching.search_by_projection(
            uvp, vis, desc, octv, radius, state.kf_uv[n],
            state.kf_feat_valid[n], state.kf_desc[n], state.kf_octave[n],
            max_dist=matching.TH_LOW)
        matched = res.idx >= 0
        j = res.idx.to(torch.int64).clamp(0, N - 1)
        tgt_obs = state.kf_obs[n][j]
        dup = matched & (tgt_obs >= 0) & (tgt_obs != obs_k)
        free = matched & (tgt_obs < 0)
        a = torch.minimum(obs_k, tgt_obs).to(torch.int64)
        b = torch.maximum(obs_k, tgt_obs).to(torch.int64)
        b_safe = torch.where(dup, b, torch.full_like(b, L))
        pass_map = torch.full((L + 1,), L, dtype=torch.int64, device=dev)
        pass_map.scatter_reduce_(0, b_safe, torch.where(dup, a, torch.full_like(a, L)),
                                 reduce="amin")
        remap = torch.where(pass_map[:L] < L, pass_map[:L], remap)
        lm_valid = ms.set_masked(lm_valid, b_safe.clamp(max=L - 1), dup, False)
        state.kf_obs[n] = torch.where(nb_ok, ms.set_masked(
            state.kf_obs[n], j, free, obs_k.to(torch.int32)), state.kf_obs[n])

    remap = remap[remap]
    obs = state.kf_obs
    relabeled = torch.where(obs >= 0, remap[obs.to(torch.int64).clamp(0, L - 1)].to(
        torch.int32), obs)
    state = state._replace(kf_obs=relabeled, lm_valid=lm_valid,
                           epoch=state.epoch + 1)
    return ms.update_landmark_stats(state, cfg.n_levels, cfg.scale)


def cull_landmarks(state: ms.MapState, n_kf: int, cfg: LocalMapConfig,
                   recent_slots=None) -> ms.MapState:
    """Remove landmarks past their grace period with < cull_min_obs
    observers, or with a found/visible ratio < 0.25; unbind them."""
    n_obs = ms.landmark_obs_count(state)
    if recent_slots is None:
        old_enough = state.lm_first_kf <= (n_kf - 1 - cfg.cull_grace_kfs)
    else:
        K = state.kf_R.shape[0]
        recent = torch.as_tensor(recent_slots, dtype=torch.int64,
                                 device=state.lm_valid.device)
        young_kf = ms.set_masked(torch.zeros(K, dtype=torch.bool,
                                              device=recent.device),
                                  recent.clamp(0, K - 1), recent >= 0, True)
        old_enough = (~young_kf[state.lm_first_kf.to(torch.int64).clamp(0, K - 1)]
                      & (state.lm_first_kf >= 0))
    weak = state.lm_valid & old_enough & (n_obs < cfg.cull_min_obs)
    ratio = state.lm_found / torch.clamp(state.lm_visible, min=1.0)
    weak |= state.lm_valid & (state.lm_visible > 8.0) & (ratio < 0.25)
    lm_valid = state.lm_valid & ~weak
    L = state.lm_pos.shape[0]
    obs = state.kf_obs
    dead = ~lm_valid[obs.to(torch.int64).clamp(0, L - 1)] & (obs >= 0)
    return state._replace(lm_valid=lm_valid,
                          kf_obs=torch.where(dead, torch.full_like(obs, -1), obs),
                          epoch=state.epoch + 1)


def redundant_keyframes(state: ms.MapState, protect_ids,
                        cfg: LocalMapConfig) -> torch.Tensor:
    """(K,) bool: keyframes whose bound landmarks are > 90% seen by >= 4
    keyframes, minus the protected ones."""
    K, N = state.kf_obs.shape
    L = state.lm_pos.shape[0]
    n_obs = ms.landmark_obs_count(state)
    obs = state.kf_obs
    bound = (obs >= 0) & state.kf_feat_valid & state.kf_valid[:, None]
    well = bound & (n_obs[obs.to(torch.int64).clamp(0, L - 1)] >= 4)
    n_bound = bound.sum(-1)
    n_well = well.sum(-1)
    redundant = (state.kf_valid
                 & (n_well.to(torch.float32) > cfg.kf_cull_redundancy
                    * torch.clamp(n_bound, min=1).to(torch.float32))
                 & (n_bound > 0))
    prot = torch.as_tensor(protect_ids, dtype=torch.int64, device=obs.device)
    prot_mask = ms.set_masked(torch.zeros(K, dtype=torch.bool, device=obs.device),
                               prot.clamp(0, K - 1), prot >= 0, True)
    return redundant & ~prot_mask
