"""Batched Levenberg-Marquardt bundle adjustment with landmark Schur
complement (port of orb_slam3_vio_fixes_tpu/optim/ba_core.py).

Ported: reprojection residuals/Jacobians, the motion-only step used by
`pose_optimize`, and `bundle_adjust` on two of the reference's solvers:
`solver="dense"` with `dense_solve="cg"` (dense struct, block-Jacobi PCG on
the explicit reduced camera system), which local BA uses, and the
matrix-free `solver="cg"` (the Schur complement applied factor-wise inside
block-Jacobi PCG, never forming a (P, L) table), which global BA uses. The
reference's `dense_solve="lu"` and unstructured dense paths are not ported:
no caller of the port selects them.

Precision: the reference forces full-f32 matmuls (`_full_f32`). On the card
PyTorch runs float32 matmuls in full float32 only while
`torch.backends.cuda.matmul.allow_tf32` is False; `set_full_f32()` sets it
(and the cuDNN flag) and the tracker calls it on construction.

Fixed iteration counts and `torch.where` selection: no host sync inside.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_vio_fixes_tpu_torch.utils import lie
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera, project, project_jac
from orb_slam3_vio_fixes_tpu_torch.utils.linalg import index_add_rows, inv3, inv6, solve6

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def set_full_f32() -> None:
    """Full-float32 matmuls and convolutions on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class ReprojFactors(NamedTuple):
    """pose_idx, lm_idx (F,) int64; uvr (F, 3) with u_right < 0 for mono;
    inv_sigma2 (F,); valid (F,) bool."""

    pose_idx: torch.Tensor
    lm_idx: torch.Tensor
    uvr: torch.Tensor
    inv_sigma2: torch.Tensor
    valid: torch.Tensor


class BAProblem(NamedTuple):
    R: torch.Tensor           # (P, 3, 3) T_cw
    t: torch.Tensor           # (P, 3)
    pose_fixed: torch.Tensor  # (P,) bool
    lm: torch.Tensor          # (L, 3)
    lm_valid: torch.Tensor    # (L,) bool
    lm_fixed: torch.Tensor    # (L,) bool
    factors: ReprojFactors
    cam: Camera
    bf: float


def _huber_weight(chi2, delta2):
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


def _pose_xc(problem, R, t, lm):
    f = problem.factors
    Rp = R[f.pose_idx]
    X = lm[f.lm_idx]
    return Rp, (Rp @ X[..., None])[..., 0] + t[f.pose_idx]


def reproj_residuals(problem: BAProblem, R=None, t=None, lm=None):
    """(err (F,3), chi2 (F,), depth (F,), is_stereo (F,))."""
    R = problem.R if R is None else R
    t = problem.t if t is None else t
    lm = problem.lm if lm is None else lm
    f = problem.factors
    _, Xc = _pose_xc(problem, R, t, lm)
    uv = project(problem.cam, Xc)
    depth = Xc[..., 2]
    inv_z = 1.0 / torch.where(depth.abs() < 1e-9, torch.full_like(depth, 1e-9),
                              depth)
    ur_pred = uv[..., 0] - problem.bf * inv_z
    is_stereo = f.uvr[:, 2] >= 0.0
    e2 = torch.where(is_stereo, ur_pred - f.uvr[:, 2], torch.zeros_like(ur_pred))
    err = torch.stack([uv[..., 0] - f.uvr[:, 0], uv[..., 1] - f.uvr[:, 1], e2], -1)
    chi2 = (err * err).sum(-1) * f.inv_sigma2
    return err, chi2, depth, is_stereo


def reproj_jacobians(problem: BAProblem, R=None, t=None, lm=None):
    """(err (F,3), Jp (F,3,6), Jl (F,3,3), chi2 (F,), depth (F,)); pose
    tangent (rho, phi), left-multiplicative on T_cw; mono row 2 zeroed."""
    R = problem.R if R is None else R
    t = problem.t if t is None else t
    lm = problem.lm if lm is None else lm
    Rp, Xc = _pose_xc(problem, R, t, lm)
    err, chi2, depth, is_stereo = reproj_residuals(problem, R, t, lm)
    Jproj = project_jac(problem.cam, Xc)
    inv_z = 1.0 / torch.where(depth.abs() < 1e-9, torch.full_like(depth, 1e-9),
                              depth)
    dur = Jproj[:, 0, :].clone()
    dur[:, 2] = dur[:, 2] + problem.bf * (inv_z * inv_z)
    Jfull = torch.cat([Jproj, dur[:, None, :]], dim=1)
    row_mask = torch.stack([torch.ones_like(depth), torch.ones_like(depth),
                            is_stereo.to(depth.dtype)], -1)
    Jfull = Jfull * row_mask[:, :, None]
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape[:-1] + (3, 3))
    dXc_dxi = torch.cat([eye, -lie.hat(Xc)], dim=-1)
    Jp = Jfull @ dXc_dxi
    Jl = Jfull @ Rp
    return err, Jp, Jl, chi2, depth


class LMConfig(NamedTuple):
    n_rounds: int = 4
    n_iters: int = 10
    init_lambda: float = 1e-3
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    huber_mono: float = CHI2_MONO**0.5
    huber_stereo: float = CHI2_STEREO**0.5
    chi2_mono: float = CHI2_MONO
    chi2_stereo: float = CHI2_STEREO
    min_depth: float = 1e-2
    motion_only: bool = False
    solver: str = "dense"       # "dense" (local windows) or "cg" (whole map)
    cg_iters: int = 40
    dense_max_obs: int = 16


def _delta2(is_stereo, cfg: LMConfig):
    return torch.where(is_stereo, cfg.huber_stereo**2, cfg.huber_mono**2).to(
        torch.float32)


def _active(problem, inlier):
    f = problem.factors
    return f.valid & inlier & problem.lm_valid[f.lm_idx]


def _rho_total(problem, chi2, is_stereo, inlier, cfg: LMConfig):
    delta2 = _delta2(is_stereo, cfg)
    rho = torch.where(chi2 <= delta2, chi2,
                      2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=0.0)) - delta2)
    return torch.where(_active(problem, inlier), rho, torch.zeros_like(rho)).sum()


def _factor_weights(problem, chi2, is_stereo, inlier, cfg: LMConfig):
    w = problem.factors.inv_sigma2 * _huber_weight(chi2, _delta2(is_stereo, cfg))
    return torch.where(_active(problem, inlier), w, torch.zeros_like(w))


def _masked_blocks(problem, inlier, cfg):
    """Shared head of both steps: residuals, weights, hard-masked Jacobians
    (0 * inf = NaN guard), fixed blocks zeroed."""
    err, Jp, Jl, chi2, _ = reproj_jacobians(problem)
    is_stereo = problem.factors.uvr[:, 2] >= 0.0
    rho = _rho_total(problem, chi2, is_stereo, inlier, cfg)
    w = _factor_weights(problem, chi2, is_stereo, inlier, cfg)
    act = w > 0.0
    zero = torch.zeros((), dtype=err.dtype, device=err.device)
    err = torch.where(act[:, None], err, zero)
    Jp = torch.where(act[:, None, None], Jp, zero)
    Jl = torch.where(act[:, None, None], Jl, zero)
    Jp = torch.where(problem.pose_fixed[problem.factors.pose_idx][:, None, None],
                     zero, Jp)
    Jl = torch.where(problem.lm_fixed[problem.factors.lm_idx][:, None, None],
                     zero, Jl)
    return err, Jp, Jl, w, rho


def _assemble_and_solve_motion(problem: BAProblem, inlier, lam, cfg: LMConfig):
    """Landmarks fixed: one damped 6x6 solve per pose."""
    P = problem.R.shape[0]
    err, Jp, _, w, rho = _masked_blocks(problem, inlier, cfg)
    wJp = w[:, None, None] * Jp
    Hpp_f = wJp.transpose(1, 2) @ Jp
    bp_f = -(wJp.transpose(1, 2) @ err[..., None])[..., 0]
    pidx = problem.factors.pose_idx
    dev = err.device
    Hpp = index_add_rows(torch.zeros((P, 6, 6), device=dev), pidx, Hpp_f)
    bp = index_add_rows(torch.zeros((P, 6), device=dev), pidx, bp_f)
    eye6 = torch.eye(6, device=dev)
    Hd = Hpp + lam * Hpp * eye6 + 1e-8 * eye6
    free = ~problem.pose_fixed
    Hd = torch.where(free[:, None, None], Hd, eye6)
    bp = torch.where(free[:, None], bp, torch.zeros_like(bp))
    return solve6(Hd, bp), torch.zeros_like(problem.lm), rho


def _damped_blocks(Hpp, Hll, pose_fixed, lam):
    dev = Hpp.device
    eye6 = torch.eye(6, device=dev)
    eye3 = torch.eye(3, device=dev)
    Hpp_d = Hpp + lam * Hpp * eye6 + 1e-10 * eye6
    Hll_d = Hll + lam * Hll * eye3
    lm_active = Hll_d.abs().sum((-1, -2)) > 1e-12
    Hll_d = torch.where(lm_active[:, None, None], Hll_d, eye3)
    mu = 1e-3 * (Hll_d[..., 0, 0] + Hll_d[..., 1, 1] + Hll_d[..., 2, 2]) / 3.0 + 1e-8
    Hll_inv = inv3(Hll_d + mu[:, None, None] * eye3)
    return Hpp_d, Hll_inv, lm_active, ~pose_fixed


class SchurStruct(NamedTuple):
    """Per-landmark observer lists: T (L, O) factor index, m (L, O) occupied,
    oh_t (L, O, P) one-hot pose of that factor (pre-masked), oh_p (F, P)."""

    T: torch.Tensor
    m: torch.Tensor
    oh_t: torch.Tensor
    oh_p: torch.Tensor


def _build_schur_struct(factors: ReprojFactors, L: int, P: int,
                        max_obs: int) -> SchurStruct:
    F_ = factors.lm_idx.shape[0]
    dev = factors.lm_idx.device
    lidx = torch.where(factors.valid, factors.lm_idx,
                       torch.full_like(factors.lm_idx, L))
    ordf = torch.argsort(lidx, stable=True)
    sl = lidx[ordf]
    start = torch.searchsorted(sl, torch.arange(L, dtype=sl.dtype, device=dev))
    rank = torch.arange(F_, device=dev) - start[sl.clamp(0, L - 1)]
    ok = (sl < L) & (rank < max_obs)
    # rows past the cap or invalid land in a dump slot that is cut off
    tgt = torch.where(ok, sl * max_obs + rank, torch.full_like(sl, L * max_obs))
    T = torch.zeros(L * max_obs + 1, dtype=torch.int64, device=dev)
    T[tgt] = ordf
    m = torch.zeros(L * max_obs + 1, dtype=torch.bool, device=dev)
    m[tgt] = ok
    T = T[:L * max_obs].reshape(L, max_obs)
    m = m[:L * max_obs].reshape(L, max_obs)
    poses = torch.arange(P, device=dev)
    # one-hot by comparison: F.one_hot checks its input range on the host
    oh_t = (factors.pose_idx[T][..., None] == poses).to(torch.float32) * m[..., None]
    oh_p = (factors.pose_idx[:, None] == poses).to(torch.float32)
    return SchurStruct(T=T, m=m, oh_t=oh_t, oh_p=oh_p)


def _dense_pcg(S, rhs, free, Hpp_d, iters: int):
    """Block-Jacobi preconditioned CG on the explicit reduced system
    S (P, P, 6, 6); fixed poses pinned to zero."""
    eye6 = torch.eye(6, device=S.device)
    Minv = inv6(torch.where(free[:, None, None], Hpp_d, eye6))
    zero = torch.zeros((), device=S.device)

    def matvec(v):
        v = torch.where(free[:, None], v, zero)
        return torch.where(free[:, None], torch.einsum("pqij,qj->pi", S, v), zero)

    def precond(r):
        return (Minv @ r[..., None])[..., 0]

    rhs = torch.where(free[:, None], rhs, zero)
    x = torch.zeros_like(rhs)
    r = rhs
    z = precond(r)
    p = z
    rz = (r * z).sum()
    for _ in range(iters):
        Ap = matvec(p)
        pAp = (p * Ap).sum()
        okc = (pAp > 1e-20) & (rz > 1e-20)
        alpha = torch.where(okc, rz / torch.where(okc, pAp, 1.0), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = (r * z).sum()
        beta = torch.where(okc, rz_new / torch.where(rz > 1e-20, rz, 1.0), zero)
        p = z + beta * p
        rz = rz_new
    return torch.where(free[:, None], x, zero)


def _assemble_and_solve_dense_struct(problem: BAProblem, inlier, lam,
                                     cfg: LMConfig, struct: SchurStruct):
    """Scatter-free dense Schur LM step over the observer-list structure."""
    P = problem.R.shape[0]
    err, Jp, Jl, w, rho = _masked_blocks(problem, inlier, cfg)
    wJp = w[:, None, None] * Jp
    wJl = w[:, None, None] * Jl
    Hpp_f = wJp.transpose(1, 2) @ Jp
    Hll_f = wJl.transpose(1, 2) @ Jl
    Hpl_f = wJp.transpose(1, 2) @ Jl
    bp_f = -(wJp.transpose(1, 2) @ err[..., None])[..., 0]
    bl_f = -(wJl.transpose(1, 2) @ err[..., None])[..., 0]

    Hpp = torch.einsum("fp,fij->pij", struct.oh_p, Hpp_f)
    bp = torch.einsum("fp,fi->pi", struct.oh_p, bp_f)
    zero = torch.zeros((), device=err.device)
    mk = struct.m[..., None, None]
    T0 = struct.T
    Hll = torch.where(mk, Hll_f[T0], zero).sum(1)
    bl = torch.where(struct.m[..., None], bl_f[T0], zero).sum(1)
    A = torch.where(mk, Hpl_f[T0], zero)                      # (L, O, 6, 3)

    Hpp_d, Hll_inv, lm_active, free = _damped_blocks(
        Hpp, Hll, problem.pose_fixed, lam)
    D = torch.einsum("lop,loij->lpij", struct.oh_t, A)        # (L, P, 6, 3)
    E = D @ Hll_inv[:, None]                                  # (L, P, 6, 3)
    S = -torch.einsum("lpik,lqjk->pqij", E, D)
    ar = torch.arange(P, device=err.device)
    S[ar, ar] = S[ar, ar] + Hpp_d
    z0 = (Hll_inv @ bl[..., None])[..., 0]
    rhs = bp - torch.einsum("lpij,lj->pi", D, z0)
    dx_pose = _dense_pcg(S, rhs, free, Hpp_d, cfg.cg_iters)
    y = torch.einsum("lpij,pi->lj", D, dx_pose)
    dlm = (Hll_inv @ (bl - y)[..., None])[..., 0]
    dlm = torch.where((problem.lm_fixed | ~lm_active)[:, None], zero, dlm)
    return dx_pose, dlm, rho


def _factor_blocks(problem: BAProblem, inlier, cfg: LMConfig):
    """Per-factor cross blocks Hpl_f (F, 6, 3) and the accumulated Hpp
    (P, 6, 6), Hll (L, 3, 3), bp (P, 6), bl (L, 3), and the robust cost."""
    P = problem.R.shape[0]
    L = problem.lm.shape[0]
    err, Jp, Jl, w, rho = _masked_blocks(problem, inlier, cfg)
    wJp = w[:, None, None] * Jp
    wJl = w[:, None, None] * Jl
    pidx, lidx = problem.factors.pose_idx, problem.factors.lm_idx
    dev = err.device
    Hpp = index_add_rows(torch.zeros((P, 6, 6), device=dev), pidx,
                         wJp.transpose(1, 2) @ Jp)
    Hll = index_add_rows(torch.zeros((L, 3, 3), device=dev), lidx,
                         wJl.transpose(1, 2) @ Jl)
    bp = index_add_rows(torch.zeros((P, 6), device=dev), pidx,
                        -(wJp.transpose(1, 2) @ err[..., None])[..., 0])
    bl = index_add_rows(torch.zeros((L, 3), device=dev), lidx,
                        -(wJl.transpose(1, 2) @ err[..., None])[..., 0])
    return wJp.transpose(1, 2) @ Jl, Hpp, Hll, bp, bl, rho


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def schur_cg_solve(Hpl_f, Hpp_d, Hll_inv, bp, bl, pidx, lidx, free,
                   cg_iters: int, psum=None):
    """Solve the Schur-reduced camera system S dx = rhs by block-Jacobi
    preconditioned CG without forming S or a (P, L) table: S v = Hpp_d v -
    Hpl Hll^-1 Hpl^T v, evaluated factor-wise with gathers and index_add.
    Fixed poses stay at zero. Returns dx_pose (P, 6).

    With the factors and landmarks sharded over a mesh (parallel/sharded_ba),
    `psum` sums each pose-space partial over the shards: one (P, 6) per CG
    iteration and one for the right-hand side."""
    Pn = Hpp_d.shape[0]
    L = Hll_inv.shape[0]
    dev = Hpp_d.device
    zero = torch.zeros((), device=dev)
    Hlp_f = Hpl_f.transpose(1, 2)
    ps = psum if psum is not None else (lambda x: x)

    def hpl_hinv_hplT(v):
        y = index_add_rows(torch.zeros((L, 3), device=dev), lidx, _mv(Hlp_f, v[pidx]))
        q = _mv(Hpl_f, _mv(Hll_inv, y)[lidx])
        return ps(index_add_rows(torch.zeros((Pn, 6), device=dev), pidx, q))

    def matvec(v):
        v = torch.where(free[:, None], v, zero)
        return torch.where(free[:, None], _mv(Hpp_d, v) - hpl_hinv_hplT(v), zero)

    q0 = _mv(Hpl_f, _mv(Hll_inv, bl)[lidx])
    rhs = bp - ps(index_add_rows(torch.zeros((Pn, 6), device=dev), pidx, q0))
    rhs = torch.where(free[:, None], rhs, zero)
    diag_ok = (Hpp_d.abs().sum((-1, -2)) > 1e-9) & free
    Minv = inv6(torch.where(diag_ok[:, None, None], Hpp_d, torch.eye(6, device=dev)))
    x = torch.zeros_like(rhs)
    r = rhs
    z = _mv(Minv, r)
    p = z
    rz = (r * z).sum()
    for _ in range(cg_iters):
        Ap = matvec(p)
        pAp = (p * Ap).sum()
        ok = (pAp > 1e-20) & (rz > 1e-20)
        alpha = torch.where(ok, rz / torch.where(ok, pAp, 1.0), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = _mv(Minv, r)
        rz_new = (r * z).sum()
        beta = torch.where(ok, rz_new / torch.where(rz > 1e-20, rz, 1.0), zero)
        p = z + beta * p
        rz = rz_new
    return torch.where(free[:, None], x, zero)


def backsub_landmarks(Hpl_f, Hll_inv, bl, dx_pose, pidx, lidx, lm_dead):
    """dl = Hll^-1 (bl - Hpl^T dx), factor-wise."""
    L = Hll_inv.shape[0]
    y = index_add_rows(torch.zeros((L, 3), device=bl.device), lidx,
                       _mv(Hpl_f.transpose(1, 2), dx_pose[pidx]))
    dlm = _mv(Hll_inv, bl - y)
    return torch.where(lm_dead[:, None], torch.zeros((), device=bl.device), dlm)


def _assemble_and_solve_cg(problem: BAProblem, inlier, lam, cfg: LMConfig):
    """Matrix-free LM step (solver="cg")."""
    Hpl_f, Hpp, Hll, bp, bl, rho = _factor_blocks(problem, inlier, cfg)
    Hpp_d, Hll_inv, lm_active, free = _damped_blocks(Hpp, Hll, problem.pose_fixed, lam)
    pidx, lidx = problem.factors.pose_idx, problem.factors.lm_idx
    dx_pose = schur_cg_solve(Hpl_f, Hpp_d, Hll_inv, bp, bl, pidx, lidx, free,
                             cfg.cg_iters)
    dlm = backsub_landmarks(Hpl_f, Hll_inv, bl, dx_pose, pidx, lidx,
                            problem.lm_fixed | ~lm_active)
    return dx_pose, dlm, rho


def _apply_step(problem: BAProblem, dx_pose, dlm):
    dR, dt = lie.se3_exp(dx_pose)
    R_new = lie.so3_normalize(dR @ problem.R)
    t_new = (dR @ problem.t[..., None])[..., 0] + dt
    return problem._replace(R=R_new, t=t_new, lm=problem.lm + dlm)


def _total_chi2(problem: BAProblem, inlier, cfg: LMConfig):
    _, chi2, _, is_stereo = reproj_residuals(problem)
    return _rho_total(problem, chi2, is_stereo, inlier, cfg)


def bundle_adjust(problem: BAProblem, cfg: LMConfig = LMConfig()):
    """LM with chi2 outlier-gating rounds, single-evaluation accept/reject
    (see the reference). Returns (problem', inlier (F,), chi2 (F,))."""
    dev = problem.R.device
    F_ = problem.factors.valid.shape[0]
    inlier = torch.ones(F_, dtype=torch.bool, device=dev)
    struct = None
    if cfg.solver not in ("dense", "cg"):
        raise ValueError(f"unknown solver {cfg.solver!r}")
    if cfg.solver == "dense" and not cfg.motion_only:
        struct = _build_schur_struct(
            problem.factors, problem.lm.shape[0], problem.R.shape[0],
            min(cfg.dense_max_obs, problem.R.shape[0] + 8))

    def step(p, lam):
        if cfg.motion_only:
            return _assemble_and_solve_motion(p, inlier, lam, cfg)
        if cfg.solver == "cg":
            return _assemble_and_solve_cg(p, inlier, lam, cfg)
        return _assemble_and_solve_dense_struct(p, inlier, lam, cfg, struct)

    for _ in range(cfg.n_rounds):
        x0 = (problem.R, problem.t, problem.lm)
        best, cur = x0, x0
        chi_best = torch.full((), float("inf"), device=dev)
        lam = torch.full((), cfg.init_lambda, device=dev)
        for _ in range(cfg.n_iters):
            p_cur = problem._replace(R=cur[0], t=cur[1], lm=cur[2])
            dxp, dlm, chi_cur = step(p_cur, lam)
            better = chi_cur < chi_best
            best = tuple(torch.where(better, c, b) for c, b in zip(cur, best))
            chi_best = torch.minimum(chi_cur, chi_best)
            lam = torch.where(better, lam * cfg.lambda_down, lam * cfg.lambda_up)
            stepped = _apply_step(p_cur, dxp, dlm)
            cand = (stepped.R, stepped.t, stepped.lm)
            cur = tuple(torch.where(better, c, b) for c, b in zip(cand, best))
        chi_fin = _total_chi2(problem._replace(R=cur[0], t=cur[1], lm=cur[2]),
                              inlier, cfg)
        take_cur = chi_fin < chi_best
        problem = problem._replace(
            R=torch.where(take_cur, cur[0], best[0]),
            t=torch.where(take_cur, cur[1], best[1]),
            lm=torch.where(take_cur, cur[2], best[2]))
        _, chi2, depth, is_stereo = reproj_residuals(problem)
        th = torch.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
        inlier = (chi2 <= th) & (depth > cfg.min_depth)
    _, chi2, _, _ = reproj_residuals(problem)
    return problem, inlier, chi2


class PoseOptResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inlier: torch.Tensor
    n_inliers: torch.Tensor


def pose_optimize(R, t, points_w, uvr, inv_sigma2, valid, cam: Camera, bf: float,
                  cfg: LMConfig = LMConfig()) -> PoseOptResult:
    """Motion-only pose optimisation: bundle_adjust with one pose and every
    landmark fixed."""
    n = points_w.shape[0]
    dev = points_w.device
    factors = ReprojFactors(
        pose_idx=torch.zeros(n, dtype=torch.int64, device=dev),
        lm_idx=torch.arange(n, device=dev), uvr=uvr, inv_sigma2=inv_sigma2,
        valid=valid)
    problem = BAProblem(
        R=R[None], t=t[None], pose_fixed=torch.zeros(1, dtype=torch.bool, device=dev),
        lm=points_w, lm_valid=torch.ones(n, dtype=torch.bool, device=dev),
        lm_fixed=torch.ones(n, dtype=torch.bool, device=dev),
        factors=factors, cam=cam, bf=bf)
    out, inlier, _ = bundle_adjust(problem, cfg._replace(motion_only=True))
    ok = inlier & valid
    return PoseOptResult(out.R[0], out.t[0], ok, ok.sum())
