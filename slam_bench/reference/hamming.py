"""Plain reference of masked Hamming best-2 matching over 256-bit ORB
descriptors held as (n, 8) int32 words."""

from __future__ import annotations

import torch

BIG = 1 << 20


def distances(desc_q: torch.Tensor, desc_t: torch.Tensor) -> torch.Tensor:
    """(Q, 8) x (T, 8) int32 words -> (Q, T) int32 Hamming distances, bit by
    bit."""
    x = (desc_q.to(torch.int64)[:, None, :] ^ desc_t.to(torch.int64)[None, :, :]) & 0xFFFFFFFF
    shifts = torch.arange(32, device=x.device, dtype=torch.int64)
    return ((x[..., None] >> shifts) & 1).sum(dim=(-1, -2)).to(torch.int32)


def best2(desc_q, desc_t, mask, cols: bool):
    """Per query row over the admissible train columns: the first index of
    the least distance and that distance, then the least distance and its
    first index once that one position is removed (BIG where none is left);
    with `cols`, per train column the first query index of the least
    admissible distance. Returns (best_idx, best, second, second_idx,
    col_idx or None), int32."""
    rows = []
    for q0 in range(0, desc_q.shape[0], 256):
        d = distances(desc_q[q0:q0 + 256], desc_t)
        rows.append(torch.where(mask[q0:q0 + 256], d, torch.full_like(d, BIG)))
    d = torch.cat(rows)
    best_idx = torch.argmin(d, dim=1)
    best = d.gather(1, best_idx[:, None])[:, 0]
    col_idx = torch.argmin(d, dim=0).to(torch.int32) if cols else None
    d = d.clone()
    d[torch.arange(d.shape[0], device=d.device), best_idx] = BIG
    second_idx = torch.argmin(d, dim=1)
    second = d.gather(1, second_idx[:, None])[:, 0]
    return (best_idx.to(torch.int32), best, second, second_idx.to(torch.int32), col_idx)
