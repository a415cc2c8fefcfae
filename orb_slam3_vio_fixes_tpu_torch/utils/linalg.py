"""Closed-form batched small-matrix linear algebra (port of
orb_slam3_vio_fixes_tpu/utils/linalg.py).

The 3x3 / 6x6 blocks of every Schur/LM solve go through these closed forms:
batched LU kernels cost a launch and a workspace per call for matrices this
small, and the closed forms keep the arithmetic identical to the reference.
"""

from __future__ import annotations

import torch


def adjugate3(A: torch.Tensor):
    """(adj(A), det(A)) of (..., 3, 3) matrices. The adjugate's columns are
    the cross products of A's rows, entry for entry the reference's
    cofactor formulas, in three cross-product launches instead of ~20
    elementwise ones (the per-frame pose optimisation runs thousands of
    these tiny launches)."""
    r0, r1, r2 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
    c0 = torch.linalg.cross(r1, r2)
    adj = torch.stack([c0, torch.linalg.cross(r2, r0),
                       torch.linalg.cross(r0, r1)], dim=-1)
    return adj, (r0 * c0).sum(-1)


def inv3(A: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Closed-form inverse of (..., 3, 3) matrices (adjugate / determinant)."""
    adj, det = adjugate3(A)
    inv_det = 1.0 / torch.where(det.abs() < 1e-20,
                                torch.full_like(det, 1e-20), det + eps)
    return adj * inv_det[..., None, None]


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (A @ x[..., None])[..., 0]


def solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (..., 6, 6) @ x = (..., 6) by 3x3 block Schur elimination with
    closed-form 3x3 inverses (SPD damped Hessians)."""
    P = A[..., :3, :3]
    Q = A[..., :3, 3:]
    Rb = A[..., 3:, :3]
    S = A[..., 3:, 3:]
    b1 = b[..., :3]
    b2 = b[..., 3:]
    Pinv = inv3(P)
    RPinv = Rb @ Pinv
    Sinv = inv3(S - RPinv @ Q)
    x2 = _mv(Sinv, b2 - _mv(RPinv, b1))
    x1 = _mv(Pinv, b1 - _mv(Q, x2))
    return torch.cat([x1, x2], dim=-1)


def inv6(A: torch.Tensor) -> torch.Tensor:
    """Closed-form (..., 6, 6) inverse via 3x3 block Schur."""
    P = A[..., :3, :3]
    Q = A[..., :3, 3:]
    Rb = A[..., 3:, :3]
    S = A[..., 3:, 3:]
    Pinv = inv3(P)
    RPinv = Rb @ Pinv
    PinvQ = Pinv @ Q
    Sinv = inv3(S - RPinv @ Q)
    tl = Pinv + PinvQ @ Sinv @ RPinv
    tr = -PinvQ @ Sinv
    bl = -Sinv @ RPinv
    return torch.cat([torch.cat([tl, tr], dim=-1),
                      torch.cat([bl, Sinv], dim=-1)], dim=-2)


def spread_dumps(idx: torch.Tensor, keep: torch.Tensor, n: int) -> torch.Tensor:
    """idx where `keep`, else a dump row of its own past `n` (n + position):
    for a scatter into n + len(idx) rows whose first n are kept. CUDA's
    deterministic index_put_ / index_add_ walk a run of equal indices one
    row after the other in one warp, so a dump row shared by the padding of
    a fixed-capacity list (up to K * N rows in a global BA) serialises the
    whole scatter."""
    return torch.where(keep, idx, n + torch.arange(idx.shape[0], device=idx.device))


def index_add_rows(out: torch.Tensor, idx: torch.Tensor, values: torch.Tensor,
                   keep: torch.Tensor = None) -> torch.Tensor:
    """out.index_add_(0, idx, values) for the rows `keep` (default: the rows
    of `values` that are not all zero, which add nothing); the other rows go
    to dump rows (`spread_dumps`). Returns out."""
    n, m = out.shape[0], idx.shape[0]
    if keep is None:
        keep = values.reshape(m, -1).ne(0).any(1)
    ext = torch.cat([out, out.new_zeros((m,) + tuple(out.shape[1:]))])
    ext.index_add_(0, spread_dumps(idx, keep, n), values)
    return out.copy_(ext[:n])


def compact_indices(mask: torch.Tensor, budget: int):
    """Stable compaction: indices of the first `budget` True entries of
    `mask`. Returns (idx (budget,) int64, filled (budget,) bool); unfilled
    slots point at index 0 — mask gathered data with `filled`. Entries past
    the budget scatter into dump slots that are cut off, so no two writes
    land on a kept index."""
    n = mask.shape[0]
    dev = mask.device
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    tgt = spread_dumps(pos, mask & (pos < budget), budget)
    out = torch.zeros(budget + n, dtype=torch.int64, device=dev)
    out[tgt] = torch.arange(n, dtype=torch.int64, device=dev)
    n_fill = torch.clamp(mask.sum(), max=budget)
    filled = torch.arange(budget, device=dev) < n_fill
    return out[:budget], filled


def topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis with ties in index order, as jax.lax.top_k
    (torch.topk orders ties arbitrarily; FAST scores and covisibility counts
    are integers and tie constantly)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-dim index tensor i, without reading i on the host (plain
    indexing with a 0-dim device tensor synchronises the stream)."""
    return x.index_select(0, i.reshape(1))[0]
