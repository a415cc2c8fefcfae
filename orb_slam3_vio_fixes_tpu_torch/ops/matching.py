"""Binary-descriptor matching (port of orb_slam3_vio_fixes_tpu/ops/matching.py).

Every matcher is a dense (Q, T) admissibility mask built in torch, reduced
by kernel K2 (`csrc/hamming.cu`) in one launch: `hamming_match` gives each
query row's best and second-best train index and, for the mutual matchers,
each train column's best query (the cross-check). On CPU tensors the wrapper
runs the plain twin `match_plain`, which materialises the distance matrix
with a SWAR popcount (torch has no popcount op).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from orb_slam3_vio_fixes_tpu_torch import kernels
from orb_slam3_vio_fixes_tpu_torch.utils.linalg import topk_stable

TH_LOW = 50
TH_HIGH = 100
HISTO_BINS = 30
BIG = 1 << 20
INT32_MAX = 2**31 - 1


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit patterns. torch's int32 >> is
    arithmetic, so every shifted value is masked before use."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + ((x >> 4) & 0x0F0F0F0F)) & 0x0F0F0F0F
    x = x + ((x >> 8) & 0x00FF00FF)
    x = x + ((x >> 16) & 0x0000FFFF)
    return x & 0x3F


def hamming_matrix(desc_q: torch.Tensor, desc_t: torch.Tensor) -> torch.Tensor:
    """(Q, 8) x (T, 8) int32 -> (Q, T) int32 Hamming distances."""
    x = desc_q[:, None, :] ^ desc_t[None, :, :]
    return popcount32(x).sum(-1, dtype=torch.int32)


def match_plain(desc_q, desc_t, mask, cols: bool):
    """Plain twin of kernel K2: (best_idx, best, second, second_idx), each
    (Q,) int32, with the reference's jnp.argmin tie rules (first index; only
    the best POSITION is removed for the second), and, when `cols`, each
    train column's first query index with the minimal masked distance, (T,)
    int32 (else None)."""
    d = torch.where(mask, hamming_matrix(desc_q, desc_t),
                    torch.full((), BIG, dtype=torch.int32, device=mask.device))
    best_idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    col_idx = torch.argmin(d, dim=0).to(torch.int32) if cols else None
    rows = torch.arange(d.shape[0], device=d.device)
    d[rows, best_idx] = BIG
    second_idx = torch.argmin(d, dim=1)
    second = torch.gather(d, 1, second_idx[:, None])[:, 0]
    return (best_idx.to(torch.int32), best, second,
            second_idx.to(torch.int32), col_idx)


def _check_k2(name, desc_q, desc_t, mask):
    if (desc_q.ndim != 2 or desc_q.shape[1] != 8 or desc_t.ndim != 2
            or desc_t.shape[1] != 8 or desc_q.dtype != torch.int32
            or desc_t.dtype != torch.int32):
        raise ValueError(f"{name}: descriptors must be (n, 8) int32")
    if mask.dtype != torch.bool or tuple(mask.shape) != (desc_q.shape[0],
                                                         desc_t.shape[0]):
        raise ValueError(f"{name}: mask must be ({desc_q.shape[0]}, "
                         f"{desc_t.shape[0]}) bool, got {tuple(mask.shape)} "
                         f"{mask.dtype}")
    if desc_q.shape[0] == 0 or desc_t.shape[0] == 0:
        raise ValueError(f"{name}: empty query or train set")


def _aligned(desc: torch.Tensor) -> torch.Tensor:
    # the kernel reads each 32-byte descriptor as two 16-byte vectors
    desc = desc.contiguous()
    return desc if desc.data_ptr() % 16 == 0 else desc.clone()


def hamming_match(desc_q: torch.Tensor, desc_t: torch.Tensor,
                  mask: torch.Tensor, cols: bool):
    """Masked Hamming best-2 per query row and, when `cols`, argmin per
    train column, in one launch of kernel K2. Returns (best_idx, best,
    second, second_idx, col_idx or None), int32."""
    _check_k2("hamming_match", desc_q, desc_t, mask)
    if desc_q.device.type == "cpu":
        return match_plain(desc_q, desc_t, mask, cols)
    desc_q, desc_t, mask = _aligned(desc_q), _aligned(desc_t), mask.contiguous()
    kernels.require_cuda("hamming_match", desc_q, desc_t, mask)
    Q, T = mask.shape
    # One allocation for the four row outputs, and the column keys (a uint64
    # (distance << 32 | query) per column) as int32 pairs whose low words are
    # the argmins: the frame loop is bound by the host's per-call cost.
    outs = torch.empty((4, Q), dtype=torch.int32, device=mask.device)
    col_key = torch.empty(2 * T, dtype=torch.int32, device=mask.device) if cols else None
    row = outs.data_ptr()
    rc = kernels.library().slam_hamming_match(
        desc_q.data_ptr(), desc_t.data_ptr(), mask.data_ptr(), Q, T, int(cols),
        row, row + 4 * Q, row + 8 * Q, row + 12 * Q,
        col_key.data_ptr() if cols else None, kernels.stream_of(mask))
    kernels.check(rc, "slam_hamming_match")
    kernels.count("hamming_match")
    kernels.count("hamming_match_cols", int(cols))
    return (*outs.unbind(0), col_key[0::2] if cols else None)


def mutual_ok(col_idx, best_idx) -> torch.Tensor:
    """q -> t matches whose t also prefers q (the reference's mutual_filter),
    from the column argmins of the same hamming_match call."""
    back = col_idx[best_idx.to(torch.int64)]
    return back == torch.arange(best_idx.shape[0], dtype=torch.int32,
                                device=back.device)


def rotation_consistency(angle_q, angle_t, match_t, valid) -> torch.Tensor:
    """Keep matches whose angle difference falls in the 3 most populated of
    30 bins (ties between bins broken by the lower bin, as jax.lax.top_k)."""
    matched_angle_t = angle_t[match_t.to(torch.int64).clamp(0, angle_t.shape[0] - 1)]
    rot = torch.remainder(angle_q - matched_angle_t, 2.0 * math.pi)
    bins = torch.clamp((rot * (HISTO_BINS / (2.0 * math.pi))).to(torch.int64),
                       0, HISTO_BINS - 1)
    counts = torch.zeros(HISTO_BINS, dtype=torch.int64, device=bins.device)
    counts.index_add_(0, bins, valid.to(torch.int64))
    top3 = topk_stable(counts, 3)[1]
    return valid & (bins[:, None] == top3[None, :]).any(dim=1)


class MatchResult(NamedTuple):
    """idx: (Q,) int32 index into the train set, -1 if unmatched; dist: (Q,)."""

    idx: torch.Tensor
    dist: torch.Tensor


def match_descriptors(desc_q, valid_q, desc_t, valid_t, angle_q=None,
                      angle_t=None, ratio: float = 0.9, max_dist: int = TH_LOW,
                      check_rotation: bool = False,
                      mutual: bool = True) -> MatchResult:
    """Nearest-neighbour matcher with ratio / mutual / rotation gates."""
    mask = valid_q[:, None] & valid_t[None, :]
    best_idx, best, second, _, col_idx = hamming_match(desc_q, desc_t, mask,
                                                       cols=mutual)
    ok = best <= max_dist
    ok &= best.to(torch.float32) < ratio * second.to(torch.float32)
    if mutual:
        ok &= mutual_ok(col_idx, best_idx)
    if check_rotation:
        ok = rotation_consistency(angle_q, angle_t, best_idx, ok)
    return MatchResult(torch.where(ok, best_idx, torch.full_like(best_idx, -1)),
                       best)


def search_by_projection(proj_uv, proj_valid, proj_desc, proj_octave, radius,
                         feat_uv, feat_valid, feat_desc, feat_octave,
                         feat_taken=None, proj_ur=None, feat_ur=None,
                         max_dist: int = TH_HIGH, ratio: float = 0.0,
                         apply_ratio_same_octave: bool = True,
                         oct_window: int = 1) -> MatchResult:
    """Windowed projection matching: radius, octave window, stereo right-u
    gate, optional same-octave ratio test, one winner per keypoint (the
    lowest distance, then the lowest query index)."""
    du = proj_uv[:, None, 0] - feat_uv[None, :, 0]
    dv = proj_uv[:, None, 1] - feat_uv[None, :, 1]
    within = (du * du + dv * dv) <= (radius[:, None] ** 2)
    oct_ok = ((feat_octave[None, :] >= proj_octave[:, None] - oct_window)
              & (feat_octave[None, :] <= proj_octave[:, None] + oct_window))
    mask = within & oct_ok & proj_valid[:, None] & feat_valid[None, :]
    if feat_taken is not None:
        mask &= ~feat_taken[None, :]
    if proj_ur is not None and feat_ur is not None:
        has_r = feat_ur[None, :] >= 0.0
        er = (proj_ur[:, None] - feat_ur[None, :]).abs()
        mask &= torch.where(has_r, er <= radius[:, None], True)

    best_idx, best, second, second_idx, _ = hamming_match(proj_desc, feat_desc,
                                                          mask, cols=False)
    ok = best <= max_dist
    n_feat = feat_uv.shape[0]
    if ratio > 0.0:
        best_oct = feat_octave[best_idx.to(torch.int64).clamp(0, n_feat - 1)]
        second_oct = feat_octave[second_idx.to(torch.int64)]
        ratio_ok = best.to(torch.float32) <= ratio * second.to(torch.float32)
        if apply_ratio_same_octave:
            ratio_ok = torch.where(best_oct == second_oct, ratio_ok, True)
        ok &= ratio_ok
    claim = best_idx.to(torch.int64).clamp(0, n_feat - 1)
    order_key = best * (1 << 12) + torch.arange(best.shape[0], dtype=torch.int32,
                                                device=best.device)
    winner = torch.full((n_feat,), INT32_MAX, dtype=torch.int32,
                        device=best.device)
    winner.scatter_reduce_(0, claim, torch.where(
        ok, order_key, torch.full_like(order_key, INT32_MAX)), reduce="amin")
    ok &= winner[claim] == order_key
    return MatchResult(torch.where(ok, best_idx, torch.full_like(best_idx, -1)),
                       best)


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median ignoring NaNs that averages the two middle values on an even
    count, as jnp.nanmedian (torch.nanmedian returns the lower one); NaN when
    every value is NaN. No host sync."""
    nan = torch.isnan(x)
    s = torch.sort(torch.where(nan, torch.full_like(x, float("inf")), x))[0]
    n = (~nan).sum()
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, max=x.shape[0] - 1)
    # gather, not s[lo]: indexing with a 0-dim device tensor reads it on the host
    mid = torch.gather(s, 0, torch.stack([lo, hi]))
    med = 0.5 * (mid[0] + mid[1])
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def stereo_row_match(uv_l, valid_l, desc_l, octave_l, uv_r, valid_r, desc_r,
                     octave_r, scale_factors, min_disp: float, max_disp: float):
    """Rectified stereo matching by row-banded Hamming search with the
    left-right cross-check and the median-distance outlier sweep.

    Returns (u_right, disp, dist), u_right = -1 where unmatched."""
    band = 2.0 * scale_factors[octave_r.to(torch.int64).clamp(
        0, scale_factors.shape[0] - 1)]
    row_ok = (uv_l[:, None, 1] - uv_r[None, :, 1]).abs() <= band[None, :]
    disp = uv_l[:, None, 0] - uv_r[None, :, 0]
    disp_ok = (disp >= min_disp) & (disp <= max_disp)
    oct_ok = ((octave_r[None, :] >= octave_l[:, None] - 1)
              & (octave_r[None, :] <= octave_l[:, None] + 1))
    mask = row_ok & disp_ok & oct_ok & valid_l[:, None] & valid_r[None, :]
    best_idx, best, _, _, col_idx = hamming_match(desc_l, desc_r, mask, cols=True)
    ok = best <= TH_HIGH
    ok &= mutual_ok(col_idx, best_idx)
    ur = uv_r[best_idx.to(torch.int64), 0]
    d = uv_l[:, 0] - ur
    d = torch.where(d < 0.01, torch.full_like(d, 0.01), d)
    bestf = best.to(torch.float32)
    med = nanmedian(torch.where(ok, bestf, torch.full_like(bestf, float("nan"))))
    med = torch.nan_to_num(med, nan=float(TH_HIGH))
    ok &= bestf <= 2.1 * med
    return (torch.where(ok, ur, torch.full_like(ur, -1.0)),
            torch.where(ok, d, torch.full_like(d, -1.0)), best)
