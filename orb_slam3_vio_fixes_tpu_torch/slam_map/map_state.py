"""Map state: fixed-capacity SoA tensors for keyframes and landmarks (port of
orb_slam3_vio_fixes_tpu/slam_map/map_state.py).

The reference's MapState is an immutable pytree whose updates XLA performs in
place through donated buffers. Here the same fields are tensors in a
NamedTuple and the writers (`insert_keyframe`, `add_landmarks`) update them
IN PLACE and return the same state. Callers that keep a row of a field
across a write take a `.clone()`.

Descriptors are int32 bit patterns of the reference's uint32 words.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_vio_fixes_tpu_torch.utils.linalg import index_add_rows, spread_dumps


class MapConfig(NamedTuple):
    max_keyframes: int = 256
    max_landmarks: int = 32768
    max_features: int = 1536
    n_levels: int = 8
    scale: float = 1.2


class MapState(NamedTuple):
    kf_R: torch.Tensor
    kf_t: torch.Tensor
    kf_ts: torch.Tensor
    kf_vel: torch.Tensor
    kf_bg: torch.Tensor
    kf_ba: torch.Tensor
    kf_prev: torch.Tensor
    kf_valid: torch.Tensor

    kf_uv: torch.Tensor
    kf_ur: torch.Tensor
    kf_octave: torch.Tensor
    kf_angle: torch.Tensor
    kf_desc: torch.Tensor
    kf_feat_valid: torch.Tensor
    kf_obs: torch.Tensor
    kf_depth: torch.Tensor

    lm_pos: torch.Tensor
    lm_valid: torch.Tensor
    lm_desc: torch.Tensor
    lm_normal: torch.Tensor
    lm_mindist: torch.Tensor
    lm_maxdist: torch.Tensor
    lm_first_kf: torch.Tensor
    lm_found: torch.Tensor
    lm_visible: torch.Tensor

    epoch: torch.Tensor


def empty(cfg: MapConfig, device) -> MapState:
    K, L, N = cfg.max_keyframes, cfg.max_landmarks, cfg.max_features
    f32, i32 = torch.float32, torch.int32
    kw = dict(device=device)
    return MapState(
        kf_R=torch.eye(3, dtype=f32, **kw).repeat(K, 1, 1),
        kf_t=torch.zeros((K, 3), dtype=f32, **kw),
        kf_ts=torch.zeros(K, dtype=f32, **kw),
        kf_vel=torch.zeros((K, 3), dtype=f32, **kw),
        kf_bg=torch.zeros((K, 3), dtype=f32, **kw),
        kf_ba=torch.zeros((K, 3), dtype=f32, **kw),
        kf_prev=torch.full((K,), -1, dtype=i32, **kw),
        kf_valid=torch.zeros(K, dtype=torch.bool, **kw),
        kf_uv=torch.zeros((K, N, 2), dtype=f32, **kw),
        kf_ur=torch.full((K, N), -1.0, dtype=f32, **kw),
        kf_octave=torch.zeros((K, N), dtype=i32, **kw),
        kf_angle=torch.zeros((K, N), dtype=f32, **kw),
        kf_desc=torch.zeros((K, N, 8), dtype=i32, **kw),
        kf_feat_valid=torch.zeros((K, N), dtype=torch.bool, **kw),
        kf_obs=torch.full((K, N), -1, dtype=i32, **kw),
        kf_depth=torch.full((K, N), -1.0, dtype=f32, **kw),
        lm_pos=torch.zeros((L, 3), dtype=f32, **kw),
        lm_valid=torch.zeros(L, dtype=torch.bool, **kw),
        lm_desc=torch.zeros((L, 8), dtype=i32, **kw),
        lm_normal=torch.zeros((L, 3), dtype=f32, **kw),
        lm_mindist=torch.zeros(L, dtype=f32, **kw),
        lm_maxdist=torch.full((L,), 1e9, dtype=f32, **kw),
        lm_first_kf=torch.full((L,), -1, dtype=i32, **kw),
        lm_found=torch.ones(L, dtype=f32, **kw),
        lm_visible=torch.ones(L, dtype=f32, **kw),
        epoch=torch.zeros((), dtype=i32, **kw),
    )


def insert_keyframe(state: MapState, kf_id: int, R, t, ts, vel, bg, ba, prev_id,
                    uv, ur, octave, angle, desc, feat_valid, obs, depth) -> MapState:
    """Write one keyframe slot in place."""
    k = int(kf_id)
    state.kf_R[k] = R
    state.kf_t[k] = t
    state.kf_ts[k] = ts
    state.kf_vel[k] = vel
    state.kf_bg[k] = bg
    state.kf_ba[k] = ba
    state.kf_prev[k] = prev_id
    state.kf_valid[k] = True
    state.kf_uv[k] = uv
    state.kf_ur[k] = ur
    state.kf_octave[k] = octave
    state.kf_angle[k] = angle
    state.kf_desc[k] = desc
    state.kf_feat_valid[k] = feat_valid
    state.kf_obs[k] = obs
    state.kf_depth[k] = depth
    return state._replace(epoch=state.epoch + 1)


def add_landmarks(state: MapState, slots, pos, desc, normal, mindist, maxdist,
                  first_kf, valid) -> MapState:
    """Batch-allocate landmarks in place. Invalid rows are redirected to the
    reserved scratch slot L-1 and write back its own value, so every write
    to one index carries the same value and the result does not depend on
    the scatter order."""
    L = state.lm_pos.shape[0]
    safe = torch.where(valid, slots.to(torch.int64), torch.full_like(
        slots, L - 1, dtype=torch.int64))
    first_kf = torch.full(slots.shape, int(first_kf), dtype=torch.int32,
                          device=slots.device)
    v1 = valid[:, None]

    def put(field, new, mask):
        field[safe] = torch.where(mask, new.to(field.dtype), field[safe])

    put(state.lm_pos, pos, v1)
    put(state.lm_desc, desc, v1)
    put(state.lm_normal, normal, v1)
    put(state.lm_mindist, mindist, valid)
    put(state.lm_maxdist, maxdist, valid)
    put(state.lm_first_kf, first_kf, valid)
    put(state.lm_valid, torch.ones_like(valid), valid)
    return state._replace(epoch=state.epoch + 1)


def observation_matrix(state: MapState) -> torch.Tensor:
    """(K, L) bool — keyframe k observes landmark l."""
    K, N = state.kf_obs.shape
    L = state.lm_pos.shape[0]
    obs = torch.where(state.kf_feat_valid & state.kf_valid[:, None],
                      state.kf_obs, torch.full_like(state.kf_obs, -1))
    flat_l = obs.reshape(-1).to(torch.int64)
    good = flat_l >= 0
    flat_k = torch.arange(K, device=obs.device).repeat_interleave(N)
    # features without a landmark write True into a dump column each
    dump = L + torch.arange(N, device=obs.device).repeat(K)
    ind = torch.zeros((K, L + N), dtype=torch.bool, device=obs.device)
    ind[flat_k, torch.where(good, flat_l, dump)] = True
    return ind[:, :L]


def covisibility(state: MapState) -> torch.Tensor:
    """(K, K) int32 shared-landmark counts (zero diagonal)."""
    ind = observation_matrix(state).to(torch.float32)
    cov = ind @ ind.T
    cov = cov * (1.0 - torch.eye(cov.shape[0], device=cov.device))
    return cov.to(torch.int32)


def landmark_obs_count(state: MapState) -> torch.Tensor:
    return observation_matrix(state).sum(0, dtype=torch.int32)


def update_landmark_stats(state: MapState, n_levels: int = 8,
                          scale: float = 1.2) -> MapState:
    """Recompute landmark normals and scale-invariance distances from the
    current observations (the reference's batched UpdateNormalAndDepth)."""
    K, N = state.kf_obs.shape
    L = state.lm_pos.shape[0]
    dev = state.kf_obs.device
    obs = torch.where(state.kf_feat_valid & state.kf_valid[:, None],
                      state.kf_obs, torch.full_like(state.kf_obs, -1))
    flat_l = obs.reshape(-1).to(torch.int64)
    good = flat_l >= 0
    tgt = torch.where(good, flat_l, torch.full_like(flat_l, L - 1))
    C = -(state.kf_R.transpose(1, 2) @ state.kf_t[..., None])[..., 0]
    cam_of_obs = torch.arange(K, device=dev).repeat_interleave(N)
    d = state.lm_pos[tgt] - C[cam_of_obs]
    dist = torch.linalg.norm(d, dim=-1)
    d_norm = d / torch.clamp(dist[:, None], min=1e-9)
    zero = torch.zeros((), device=dev)
    normal_sum = index_add_rows(torch.zeros((L, 3), device=dev), tgt,
                                torch.where(good[:, None], d_norm, zero), good)
    cnt = index_add_rows(torch.zeros(L, device=dev), tgt, good.to(torch.float32), good)
    normal = normal_sum / torch.clamp(cnt[:, None], min=1.0)
    normal = normal / torch.clamp(torch.linalg.norm(normal, dim=-1, keepdim=True),
                                  min=1e-9)
    sf = scale ** state.kf_octave.reshape(-1).to(torch.float32)
    maxd_sum = index_add_rows(torch.zeros(L, device=dev), tgt,
                              torch.where(good, dist * sf, zero), good)
    maxdist = maxd_sum / torch.clamp(cnt, min=1.0)
    mindist = maxdist / (scale ** (n_levels - 1))
    keep = state.lm_valid
    return state._replace(
        lm_normal=torch.where(keep[:, None], normal, state.lm_normal),
        lm_maxdist=torch.where(keep, torch.clamp(maxdist, min=1e-6),
                               state.lm_maxdist),
        lm_mindist=torch.where(keep, mindist, state.lm_mindist))


def excise_keyframes(state: MapState, cull_ids: torch.Tensor) -> MapState:
    """Remove keyframes (-1 = no-op pad): unbind their observations, splice
    the temporal chain, re-anchor landmarks whose anchor died."""
    K, N = state.kf_obs.shape
    safe = cull_ids.to(torch.int64).clamp(0, K - 1)
    kf_valid = set_masked(state.kf_valid, safe, cull_ids >= 0, False)
    dead_row = ~kf_valid[:, None]
    kf_obs = torch.where(dead_row, torch.full_like(state.kf_obs, -1), state.kf_obs)
    kf_feat_valid = state.kf_feat_valid & ~dead_row
    prev = state.kf_prev
    for _ in range(int(cull_ids.shape[0])):
        p_ok = prev >= 0
        p = prev.to(torch.int64).clamp(0, K - 1)
        prev = torch.where(p_ok & ~kf_valid[p], state.kf_prev[p], prev)
    st2 = state._replace(kf_valid=kf_valid, kf_obs=kf_obs,
                         kf_feat_valid=kf_feat_valid)
    obs_mat = observation_matrix(st2)
    first_obs = torch.argmax(obs_mat.to(torch.uint8), dim=0).to(torch.int32)
    has_obs = obs_mat.any(dim=0)
    anchor = state.lm_first_kf.to(torch.int64).clamp(0, K - 1)
    anchor_dead = (state.lm_first_kf >= 0) & ~kf_valid[anchor]
    lm_first_kf = torch.where(
        anchor_dead, torch.where(has_obs, first_obs, torch.full_like(first_obs, -1)),
        state.lm_first_kf)
    return st2._replace(kf_prev=prev, lm_first_kf=lm_first_kf,
                        epoch=state.epoch + 1)


def set_masked(field: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
                value) -> torch.Tensor:
    """Copy of `field` with field[idx[i]] = value where mask[i]; unmasked rows
    go to dump rows past the end, one each, so a pad index (clamped to a
    real one) never races a real write (index_put_ with duplicate indices
    has no defined winner on the GPU) and never serialises the scatter
    (`linalg.spread_dumps`)."""
    n, m = field.shape[0], idx.shape[0]
    ext = torch.cat([field, field.new_zeros((m,) + tuple(field.shape[1:]))])
    if not isinstance(value, torch.Tensor):
        # a Python scalar would go to the card by a synchronising copy
        value = field.new_full((), value)
    ext[spread_dumps(idx, mask, n)] = value
    return ext[:n]


def grow_map(state: MapState, old: MapConfig, new: MapConfig) -> MapState:
    """Pad every field to a bigger capacity tier. The old scratch slot
    (L_old - 1) becomes a live slot, so it is reset to its empty value."""
    assert new.max_keyframes >= old.max_keyframes
    assert new.max_landmarks >= old.max_landmarks
    assert new.max_features == old.max_features
    tmpl = empty(new, state.kf_R.device)
    out = {}
    for name in MapState._fields:
        a = getattr(state, name)
        b = getattr(tmpl, name)
        if name == "epoch":
            out[name] = a + 1
            continue
        if a.shape != b.shape:
            b[tuple(slice(0, s) for s in a.shape)] = a
            if name.startswith("lm_"):
                b[old.max_landmarks - 1] = getattr(tmpl, name)[-1]
            out[name] = b
        else:
            out[name] = a
    return MapState(**out)


def ba_factors_from_map(state: MapState, kf_window: torch.Tensor,
                        inv_sigma2_per_octave: torch.Tensor):
    """Factors covering the observations of the `kf_window` keyframes:
    (pose_idx local to the window, lm_idx, uvr, inv_sigma2, valid), flat
    (W * N,)."""
    W = kf_window.shape[0]
    K, N = state.kf_obs.shape
    safe_kf = kf_window.to(torch.int64).clamp(0, K - 1)
    win_ok = (kf_window >= 0) & state.kf_valid[safe_kf]
    obs = state.kf_obs[safe_kf]
    valid = win_ok[:, None] & state.kf_feat_valid[safe_kf] & (obs >= 0)
    dev = obs.device
    pose_idx = torch.arange(W, device=dev)[:, None].expand(W, N).reshape(-1)
    lm_idx = obs.to(torch.int64).clamp(0, state.lm_pos.shape[0] - 1).reshape(-1)
    uvr = torch.cat([state.kf_uv[safe_kf], state.kf_ur[safe_kf][..., None]],
                    dim=-1).reshape(-1, 3)
    n_oct = inv_sigma2_per_octave.shape[0]
    inv_s2 = inv_sigma2_per_octave[
        state.kf_octave[safe_kf].to(torch.int64).clamp(0, n_oct - 1)]
    return pose_idx, lm_idx, uvr, inv_s2.reshape(-1), valid.reshape(-1)
