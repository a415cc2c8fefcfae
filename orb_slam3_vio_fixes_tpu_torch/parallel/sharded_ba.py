"""Distributed bundle adjustment: landmark-sharded Schur reduction on a mesh
(port of orb_slam3_vio_fixes_tpu/parallel/sharded_ba.py).

The landmark blocks and their reprojection factors are split over the
mesh's shards; the poses are replicated. Each shard forms its partial of
the reduced camera system, the partials are summed over the shards
(`Axis.psum`), every shard solves the same reduced system and
back-substitutes its own landmarks. The traffic per LM iteration is
pose-sized: (P, 6, 6) + (P, 6) blocks and, with the matrix-free solver, one
(P, 6) partial per CG iteration, and one scalar chi2 per acceptance test.

`partition_problem` orders the factors so that factor f lives on the shard
owning landmark lm_idx[f] (contiguous landmark blocks), every shard padded
to the largest shard's factor count, as the reference lays them out.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam3_vio_fixes_tpu_torch.optim import ba_core
from orb_slam3_vio_fixes_tpu_torch.parallel.mesh import Mesh, P, shard_map
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms
from orb_slam3_vio_fixes_tpu_torch.utils.linalg import index_add_rows, inv3

GBA_CONFIG = ba_core.LMConfig(n_rounds=2, n_iters=8, solver="cg", cg_iters=40)


def partition_layout(lm_idx: np.ndarray, valid: np.ndarray, n_lm: int, n_shards: int):
    """Host-side layout: (idx_out (F_new,) original factor per slot, valid_out
    (F_new,), padded landmark count Lp). Factors are grouped by the shard
    owning their landmark, stably, each shard's run padded with factor 0
    marked invalid."""
    Lp = ((n_lm + n_shards - 1) // n_shards) * n_shards
    block = Lp // n_shards
    shard_of = lm_idx // block
    order = np.argsort(shard_of, kind="stable")
    counts = np.bincount(shard_of[order], minlength=n_shards)
    per = max(int(counts.max()) if counts.size else 1, 1)
    idx_out = np.zeros(per * n_shards, np.int64)
    valid_out = np.zeros(per * n_shards, bool)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for s in range(n_shards):
        sel = order[starts[s]:starts[s] + counts[s]]
        idx_out[s * per:s * per + counts[s]] = sel
        valid_out[s * per:s * per + counts[s]] = valid[sel]
    return idx_out, valid_out, Lp


def _pad_rows(a: torch.Tensor, n: int, fill) -> torch.Tensor:
    if n == 0:
        return a
    return torch.cat([a, torch.full((n,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                                    device=a.device)])


def partition_problem(problem: ba_core.BAProblem, n_shards: int) -> ba_core.BAProblem:
    """Pad L to a multiple of the shard count (pad landmarks invalid and
    fixed) and lay the factors out as [shard 0 | shard 1 | ...] with equal
    shard sizes. The layout is computed on the host."""
    L = int(problem.lm.shape[0])
    f = problem.factors
    dev = problem.lm.device
    idx_out, valid_out, Lp = partition_layout(
        f.lm_idx.cpu().numpy(), f.valid.cpu().numpy(), L, n_shards)
    take = torch.from_numpy(idx_out).to(dev)
    factors = ba_core.ReprojFactors(
        pose_idx=f.pose_idx[take], lm_idx=f.lm_idx[take], uvr=f.uvr[take],
        inv_sigma2=f.inv_sigma2[take], valid=torch.from_numpy(valid_out).to(dev))
    pad = Lp - L
    return problem._replace(lm=_pad_rows(problem.lm, pad, 0.0),
                            lm_valid=_pad_rows(problem.lm_valid, pad, False),
                            lm_fixed=_pad_rows(problem.lm_fixed, pad, True),
                            factors=factors)


def _shard_step_cg(problem: ba_core.BAProblem, inlier, lam, cfg, ax):
    """Matrix-free distributed Schur step (cfg.solver == "cg"): no (P, L)
    table on any shard. One psum of the (P, 6, 6) + (P, 6) camera blocks,
    then one (P, 6) psum per CG iteration."""
    Hpl_f, Hpp, Hll, bp, bl, _ = ba_core._factor_blocks(problem, inlier, cfg)
    Hpp = ax.psum(Hpp)
    bp = ax.psum(bp)
    Hpp_d, Hll_inv, lm_active, free = ba_core._damped_blocks(
        Hpp, Hll, problem.pose_fixed, lam)
    pidx, lidx = problem.factors.pose_idx, problem.factors.lm_idx
    dx_pose = ba_core.schur_cg_solve(Hpl_f, Hpp_d, Hll_inv, bp, bl, pidx, lidx, free,
                                     cfg.cg_iters, psum=ax.psum)
    dlm = ba_core.backsub_landmarks(Hpl_f, Hll_inv, bl, dx_pose, pidx, lidx,
                                    problem.lm_fixed | ~lm_active)
    return dx_pose, dlm


def _shard_step(problem: ba_core.BAProblem, inlier, lam, cfg, ax):
    """One LM step on this shard's factors and landmarks (poses
    replicated). Returns (dx_pose, replicated; dlm, this shard's)."""
    if cfg.solver == "cg":
        return _shard_step_cg(problem, inlier, lam, cfg, ax)
    P_ = problem.R.shape[0]
    L_loc = problem.lm.shape[0]
    dev = problem.lm.device
    err, Jp, Jl, w, _ = ba_core._masked_blocks(problem, inlier, cfg)
    wJp = w[:, None, None] * Jp
    wJl = w[:, None, None] * Jl
    pidx, lidx = problem.factors.pose_idx, problem.factors.lm_idx
    Hpp = index_add_rows(torch.zeros((P_, 6, 6), device=dev), pidx,
                         wJp.transpose(1, 2) @ Jp)
    Hll = index_add_rows(torch.zeros((L_loc, 3, 3), device=dev), lidx,
                         wJl.transpose(1, 2) @ Jl)
    bp = index_add_rows(torch.zeros((P_, 6), device=dev), pidx,
                        -(wJp.transpose(1, 2) @ err[..., None])[..., 0])
    bl = index_add_rows(torch.zeros((L_loc, 3), device=dev), lidx,
                        -(wJl.transpose(1, 2) @ err[..., None])[..., 0])
    Hpl = index_add_rows(torch.zeros((P_ * L_loc, 6, 3), device=dev), pidx * L_loc + lidx,
                         wJp.transpose(1, 2) @ Jl).reshape(P_, L_loc, 6, 3)
    eye6 = torch.eye(6, device=dev)
    eye3 = torch.eye(3, device=dev)
    zero = torch.zeros((), device=dev)
    Hll_d = Hll + lam * Hll * eye3
    lm_active = Hll_d.abs().sum((-1, -2)) > 1e-12
    Hll_d = torch.where(lm_active[:, None, None], Hll_d, eye3)
    mu = 1e-3 * (Hll_d[..., 0, 0] + Hll_d[..., 1, 1] + Hll_d[..., 2, 2]) / 3.0 + 1e-8
    Hll_inv = inv3(Hll_d + mu[:, None, None] * eye3)
    HplHinv = torch.einsum("plij,ljk->plik", Hpl, Hll_inv)
    S_part = -torch.einsum("plik,qljk->pqij", HplHinv, Hpl)
    ar = torch.arange(P_, device=dev)
    S_part[ar, ar] = S_part[ar, ar] + (Hpp + lam * Hpp * eye6)
    rhs_part = bp - torch.einsum("plik,lk->pi", HplHinv, bl)
    # the collective: the reduced camera system summed over the shards
    S = ax.psum(S_part)
    rhs = ax.psum(rhs_part)
    Sd = S.permute(0, 2, 1, 3).reshape(P_ * 6, P_ * 6)
    free = (~problem.pose_fixed)[:, None].expand(P_, 6).reshape(-1)
    Sd = torch.where(free[:, None] & free[None, :], Sd, zero)
    Sd = Sd + torch.diag(torch.where(free, zero, torch.ones((), device=dev)))
    rhs_flat = torch.where(free, rhs.reshape(-1), zero)
    d = torch.sqrt(torch.clamp(torch.diagonal(Sd), min=1e-12))
    A = Sd / d[:, None] / d[None, :] + 1e-8 * torch.eye(P_ * 6, device=dev)
    dx = torch.linalg.solve(A, rhs_flat / d) / d
    dx_pose = dx.reshape(P_, 6)
    Hlp_dx = torch.einsum("plij,pi->lj", Hpl, dx_pose)
    dlm = (Hll_inv @ (bl - Hlp_dx)[..., None])[..., 0]
    dlm = torch.where((problem.lm_fixed | ~lm_active)[:, None], zero, dlm)
    return dx_pose, dlm


def distributed_bundle_adjust(problem: ba_core.BAProblem, mesh: Mesh,
                              cfg: ba_core.LMConfig = ba_core.LMConfig(n_rounds=2,
                                                                       n_iters=5),
                              axis: str = "lm"):
    """The whole LM loop on every shard: each LM iteration takes a step from
    the shards' reduced system and accepts it if the chi2 summed over the
    shards falls. `problem` must come from
    `partition_problem(problem, mesh.shape[axis])`. Returns (problem',
    inlier, chi2), inlier / chi2 in the partitioned factor order, on the
    problem's device."""
    n_dev = mesh.shape[axis]
    block = problem.lm.shape[0] // n_dev
    f = problem.factors

    def body(ax, R, t, pose_fixed, lm, lm_valid, lm_fixed, f_pose, f_lm, f_uvr, f_is2,
             f_valid, cam, bf):
        dev = lm.device
        # a shard's pad factors carry another shard's landmark: clamp their
        # local index (they are invalid and weigh nothing)
        local = (f_lm - ax.axis_index * block).clamp(0, block - 1)
        prob = ba_core.BAProblem(R, t, pose_fixed, lm, lm_valid, lm_fixed,
                                 ba_core.ReprojFactors(f_pose, local, f_uvr, f_is2, f_valid),
                                 cam, bf)
        inlier = torch.ones(f_pose.shape[0], dtype=torch.bool, device=dev)

        def tot_chi2(p, inl):
            return ax.psum(ba_core._total_chi2(p, inl, cfg))

        for _ in range(cfg.n_rounds):
            best = tot_chi2(prob, inlier)
            lam = torch.full((), cfg.init_lambda, device=dev)
            for _ in range(cfg.n_iters):
                dxp, dlm = _shard_step(prob, inlier, lam, cfg, ax)
                cand = ba_core._apply_step(prob, dxp, dlm)
                new = tot_chi2(cand, inlier)
                accept = new < best
                prob = prob._replace(R=torch.where(accept, cand.R, prob.R),
                                     t=torch.where(accept, cand.t, prob.t),
                                     lm=torch.where(accept, cand.lm, prob.lm))
                lam = torch.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up)
                best = torch.where(accept, new, best)
            _, chi2, depth, is_stereo = ba_core.reproj_residuals(prob)
            th = torch.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
            inlier = (chi2 <= th) & (depth > cfg.min_depth)
        _, chi2, _, _ = ba_core.reproj_residuals(prob)
        return prob.R, prob.t, prob.lm, inlier, chi2

    run = shard_map(body, mesh,
                    in_specs=(P(), P(), P(), P(axis), P(axis), P(axis), P(axis), P(axis),
                              P(axis), P(axis), P(axis), P(), P()),
                    out_specs=(P(), P(), P(axis), P(axis), P(axis)),
                    out_device=problem.R.device)
    R, t, lm, inlier, chi2 = run(problem.R, problem.t, problem.pose_fixed, problem.lm,
                                 problem.lm_valid, problem.lm_fixed, f.pose_idx, f.lm_idx,
                                 f.uvr, f.inv_sigma2, f.valid, problem.cam, problem.bf)
    return problem._replace(R=R, t=t, lm=lm), inlier, chi2


def distributed_global_ba(state: ms.MapState, inv_sigma2_oct, cam, bf, mesh: Mesh,
                          fixed_kf: int = 0, cfg: ba_core.LMConfig = GBA_CONFIG,
                          axis: str = "lm", n_levels: int = 8, scale: float = 1.2):
    """Global BA of a whole MapState across a mesh: the factor extraction of
    optim/global_ba.run_global_ba, landmark blocks and their factors on the
    shards, the reduced camera system summed over them (matrix-free CG when
    cfg.solver == "cg"). Observations that end as outliers are unbound in
    the original (K, N) order, from residuals re-evaluated on the corrected
    state. Returns (state', n_inlier_factors as a 0-dim tensor); the state
    is a new tuple (its untouched fields shared with the input)."""
    K, N = state.kf_obs.shape
    L = state.lm_pos.shape[0]
    window = torch.arange(K, device=state.kf_obs.device)
    pose_idx, lm_idx, uvr, inv_s2, valid = ms.ba_factors_from_map(
        state, window, inv_sigma2_oct)
    n_obs = ms.landmark_obs_count(state)
    valid = valid & (n_obs[lm_idx] >= 2)
    pose_fixed = ~state.kf_valid
    pose_fixed[int(fixed_kf)] = True
    problem = ba_core.BAProblem(
        R=state.kf_R, t=state.kf_t, pose_fixed=pose_fixed, lm=state.lm_pos,
        lm_valid=state.lm_valid, lm_fixed=n_obs < 2,
        factors=ba_core.ReprojFactors(pose_idx, lm_idx, uvr, inv_s2, valid),
        cam=cam, bf=bf)
    part = partition_problem(problem, mesh.shape[axis])
    out, _, _ = distributed_bundle_adjust(part, mesh, cfg, axis)
    upd = state.kf_valid & ~pose_fixed
    new_state = state._replace(
        kf_R=torch.where(upd[:, None, None], out.R, state.kf_R),
        kf_t=torch.where(upd[:, None], out.t, state.kf_t),
        lm_pos=out.lm[:L], epoch=state.epoch + 1)
    final = problem._replace(R=new_state.kf_R, t=new_state.kf_t, lm=new_state.lm_pos)
    _, chi2, depth, is_stereo = ba_core.reproj_residuals(final)
    th = torch.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
    inlier = (chi2 <= th) & (depth > cfg.min_depth)
    drop = (valid & ~inlier).reshape(K, N)
    new_state = new_state._replace(
        kf_obs=torch.where(drop, torch.full_like(state.kf_obs, -1), state.kf_obs))
    new_state = ms.update_landmark_stats(new_state, n_levels, scale)
    return new_state, (valid & inlier).sum()
