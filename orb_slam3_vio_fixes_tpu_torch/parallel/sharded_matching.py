"""Distributed descriptor matching: database rows sharded over a mesh (port
of orb_slam3_vio_fixes_tpu/parallel/sharded_matching.py).

A database of D descriptors (or a map's landmark table) is split row-wise
over the mesh's shards; the query batch is replicated. Each shard reduces
its (Q, D / n) block in one launch of kernel K2 (`ops/matching.hamming_match`,
rows only), and the shards' winners combine in two min-reductions of Q
scalars: the global best as the minimum of a packed (distance, global row)
key, the global second as the minimum of each shard's local second, or its
local best where that best lost.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam3_vio_fixes_tpu_torch.ops import matching
from orb_slam3_vio_fixes_tpu_torch.parallel.mesh import Mesh, P, shard_map

# distances are <= 256 bits; 511 is the "no admissible row" distance (it
# never passes max_dist), and the packed key keeps 22 bits of row index
SENTINEL = 511
IDX_BITS = 22


def _as_desc(desc, device) -> torch.Tensor:
    if isinstance(desc, np.ndarray):
        desc = torch.from_numpy(np.ascontiguousarray(desc).view(np.int32))
    return desc.to(device=device, dtype=torch.int32)


def pad_database(desc, valid, n_shards: int):
    """Pad the database rows to a multiple of n_shards with invalid rows.
    desc (D, 8) uint32 / int32 (numpy or tensor), valid (D,) bool; returns
    tensors on desc's device (the CPU for numpy)."""
    device = desc.device if isinstance(desc, torch.Tensor) else "cpu"
    desc = _as_desc(desc, device)
    valid = torch.as_tensor(valid, device=device).to(torch.bool)
    D = desc.shape[0]
    Dp = ((D + n_shards - 1) // n_shards) * n_shards
    if Dp >= 1 << IDX_BITS:
        raise ValueError(
            f"database rows ({Dp}) exceed the 22-bit index budget of the packed "
            "(dist << 22 | idx) winner reduction: shard the database into <4M-row blocks")
    if Dp != D:
        desc = torch.cat([desc, desc.new_zeros((Dp - D, 8))])
        valid = torch.cat([valid, valid.new_zeros(Dp - D)])
    return desc, valid


def sharded_match(query_desc, query_valid, db_desc, db_valid, mesh: Mesh,
                  axis: str = "db", max_dist: int = 64):
    """For each query: the global best database row, its distance and the
    second-best distance (for ratio tests), each shard's block reduced by
    one K2 launch and the winners by two min-reductions. Inputs (Q, 8) /
    (Dp, 8) int32, (Q,) / (Dp,) bool with Dp % n_shards == 0. Returns
    (idx (Q,), best (Q,), second (Q,)) int32 on the query's device; idx = -1
    where no row passes max_dist or the query is invalid."""
    n_dev = mesh.shape[axis]
    D = db_desc.shape[0]
    if D >= 1 << IDX_BITS:
        raise ValueError(f"db_desc rows ({D}) exceed the 22-bit packed-index budget; "
                         "split the database into <4M-row blocks")
    if D % n_dev:
        raise ValueError(f"{D} database rows do not split into {n_dev} shards: "
                         "pad_database first")
    block = D // n_dev

    def body(ax, q, qv, d, dv):
        mask = qv[:, None] & dv[None, :]
        best_loc, bd, sd, _, _ = matching.hamming_match(q, d, mask, cols=False)
        bd = bd.clamp(max=SENTINEL).to(torch.int64)
        sd = sd.clamp(max=SENTINEL).to(torch.int64)
        gidx = best_loc.to(torch.int64) + ax.axis_index * block
        packed = bd * (1 << IDX_BITS) + gidx
        packed_min = ax.pmin(packed)
        g_best = packed_min // (1 << IDX_BITS)
        g_idx = packed_min % (1 << IDX_BITS)
        # second best: the minimum over the local seconds and the local
        # bests that lost
        lost = packed != packed_min
        g_second = ax.pmin(torch.where(lost, bd, sd))
        ok = (g_best <= max_dist) & qv
        return (torch.where(ok, g_idx, torch.full_like(g_idx, -1)).to(torch.int32),
                g_best.to(torch.int32), g_second.to(torch.int32))

    run = shard_map(body, mesh, in_specs=(P(), P(), P(axis), P(axis)),
                    out_specs=(P(), P(), P()), out_device=query_desc.device)
    return run(query_desc, query_valid, db_desc, db_valid)


def sharded_global_bind(frame_desc, frame_valid, lm_desc, lm_valid, mesh: Mesh,
                        axis: str = "db", max_dist: int = matching.TH_LOW,
                        ratio: float = 0.75):
    """Bind every frame feature to its globally best map landmark by
    descriptor alone, the landmark table row-sharded over the mesh (the
    relocalisation's whole-map search: no candidate retrieval). Returns
    (N,) landmark ids, -1 unmatched; the absolute-distance gate and the
    strict Lowe ratio (a 0-distance tie rejects) applied."""
    idx, best, second = sharded_match(frame_desc, frame_valid, lm_desc, lm_valid, mesh,
                                      axis=axis, max_dist=max_dist)
    ok = (idx >= 0) & (best.to(torch.float32) < ratio * second.to(torch.float32))
    return torch.where(ok, idx, torch.full_like(idx, -1))
