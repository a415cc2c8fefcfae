"""FAST-9/16 corner scoring and atlas keypoint selection (port of
orb_slam3_vio_fixes_tpu/ops/fast.py).

`fast_score_batch` is the wrapper of kernel K1 (`csrc/fast_score.cu`), which
replaces the Pallas kernel `ops/pallas_kernels.py::fast_score_batch`: on a
CUDA tensor it launches the kernel, on a CPU tensor it runs the plain twin
`fast_score_plain` (the reference's `_fast_score_xla`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from orb_slam3_vio_fixes_tpu_torch import kernels
from orb_slam3_vio_fixes_tpu_torch.utils.linalg import topk_stable

CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
BORDER = 3
ARC = 9


def fast_score_plain(imgs: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9/16 arc score of (B, H, W) float32 images with integer-
    valued intensities (rounded half-to-even first). The ring differences
    are integers in [-255, 255], held as int16, so this equals the integer
    arithmetic of the kernel and the reference's bf16 arithmetic bit for
    bit. The 9-long arc minima come from the chain of pairwise minima
    2 -> 4 -> 8 -> 9 over the ring wrapped to 24 entries (4 passes instead
    of 8); the dark arc is the negated arc MAXIMUM of the same differences."""
    _, h, w = imgs.shape
    x = torch.round(imgs.to(torch.float32))
    pad = F.pad(x[:, None], (BORDER,) * 4, mode="replicate")[:, 0].to(torch.int16)
    c = pad[:, BORDER:BORDER + h, BORDER:BORDER + w]
    d = torch.stack([pad[:, BORDER + dy:BORDER + dy + h,
                         BORDER + dx:BORDER + dx + w] for dy, dx in CIRCLE]) - c
    dw = torch.cat([d, d[:ARC - 1]], dim=0)                    # (24, B, H, W)

    def arc(op):
        m2 = op(dw[:-1], dw[1:])
        m4 = op(m2[:-2], m2[2:])
        m8 = op(m4[:-4], m4[4:])
        return op(m8[:16], dw[ARC - 1:ARC - 1 + 16])

    bright = arc(torch.minimum).amax(dim=0)
    dark = -arc(torch.maximum).amin(dim=0)
    score = torch.clamp(torch.maximum(bright, dark), min=0).to(torch.float32)
    yy = torch.arange(h, device=imgs.device)[:, None]
    xx = torch.arange(w, device=imgs.device)[None, :]
    inb = (yy >= BORDER) & (yy < h - BORDER) & (xx >= BORDER) & (xx < w - BORDER)
    return torch.where(inb[None], score, torch.zeros_like(score))


def fast_score_batch(imgs: torch.Tensor) -> torch.Tensor:
    """Batched dense FAST score, (B, H, W) float32 -> (B, H, W) float32."""
    if imgs.ndim != 3 or imgs.dtype != torch.float32:
        raise ValueError("fast_score_batch: expected (B, H, W) float32, got "
                         f"{tuple(imgs.shape)} {imgs.dtype}")
    if imgs.device.type == "cpu":
        return fast_score_plain(imgs)
    kernels.require_cuda("fast_score_batch", imgs)
    B, H, W = imgs.shape
    out = torch.empty_like(imgs)
    rc = kernels.library().slam_fast_score(
        imgs.data_ptr(), out.data_ptr(), B, H, W, kernels.stream_of(imgs))
    kernels.check(rc, "slam_fast_score")
    fast_score_batch.launches += 1
    return out


fast_score_batch.launches = 0


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression mask of (B, H, W) scores."""
    _, h, w = score.shape
    p = F.pad(score, (1, 1, 1, 1), value=-1.0)
    neigh = torch.stack([p[:, dy:dy + h, dx:dx + w] for dy in range(3)
                         for dx in range(3) if not (dy == 1 and dx == 1)])
    return score >= neigh.amax(dim=0)


def _cell_pool_max(x: torch.Tensor, cell: int) -> torch.Tensor:
    """Max over cell x cell tiles of (B, H, W), broadcast back to pixels."""
    b, h, w = x.shape
    ph, pw = (-h) % cell, (-w) % cell
    xp = F.pad(x, (0, pw, 0, ph), value=-float("inf"))
    hc, wc = (h + ph) // cell, (w + pw) // cell
    pooled = xp.reshape(b, hc, cell, wc, cell).amax(dim=(2, 4))
    back = pooled.repeat_interleave(cell, 1).repeat_interleave(cell, 2)
    return back[:, :h, :w]


@functools.lru_cache(maxsize=None)
def _atlas_level_map(layout, device) -> torch.Tensor:
    """Atlas pixel -> pyramid level (-1 between levels); cached per device
    (read-only), so the frame loop copies nothing to the card."""
    m = np.full((layout.total_h, layout.width), -1, np.int64)
    for lvl, (off, lh, lw) in enumerate(
            zip(layout.offsets, layout.heights, layout.widths)):
        m[off:off + lh, :lw] = lvl
    return torch.as_tensor(m, device=device)


@functools.lru_cache(maxsize=None)
def _atlas_interior_mask(layout, border: int, device) -> torch.Tensor:
    """Detectable pixels: each level's interior shrunk by `border`."""
    m = np.zeros((layout.total_h, layout.width), bool)
    for off, lh, lw in zip(layout.offsets, layout.heights, layout.widths):
        if lh > 2 * border and lw > 2 * border:
            m[off + border:off + lh - border, border:lw - border] = True
    return torch.as_tensor(m, device=device)


def detect_atlas_from_score(s: torch.Tensor, layout, budgets: tuple,
                            threshold: float = 20.0, threshold_min: float = 7.0,
                            cell: int = 35, max_per_cell: int = 4,
                            border: int = 16):
    """FAST keypoints over (B, H, W) atlas scores: one dense NMS/pool pass for
    all levels, per-cell top-`max_per_cell` by iterated argmax, then a
    per-level top-k to each level's budget.

    Returns (ay, ax, score, valid, octave), each (B, sum(budgets)), with
    ay/ax in atlas coordinates."""
    dev = s.device
    interior = _atlas_interior_mask(layout, border, dev)
    s = torch.where(interior[None], s, torch.zeros_like(s))
    keep = nms3(s)
    strong = s > threshold
    weak = s > threshold_min
    cell_has_strong = _cell_pool_max(strong.to(torch.float32), cell) > 0.5
    admissible = keep & torch.where(cell_has_strong, strong, weak)
    sc = torch.where(admissible, s, torch.zeros_like(s))

    B, h_all, W = sc.shape
    hc, wc = -(-h_all // cell), -(-W // cell)
    xp = F.pad(sc, (0, wc * cell - W, 0, hc * cell - h_all))
    cells = xp.reshape(B, hc, cell, wc, cell).permute(0, 1, 3, 2, 4).reshape(
        B, hc, wc, cell * cell)
    cy = torch.arange(hc, device=dev)[:, None]
    cx = torch.arange(wc, device=dev)[None, :]
    ar = torch.arange(cell * cell, device=dev)
    cand_sc_l, cand_ay_l, cand_ax_l = [], [], []
    for _ in range(max_per_cell):
        j = torch.argmax(cells, dim=-1)                       # first max
        v = torch.take_along_dim(cells, j[..., None], dim=-1)[..., 0]
        cand_sc_l.append(v.reshape(B, -1))
        cand_ay_l.append((cy * cell + j // cell).reshape(B, -1))
        cand_ax_l.append((cx * cell + j % cell).reshape(B, -1))
        cells = torch.where(ar == j[..., None], torch.zeros_like(cells), cells)
    cand_sc = torch.cat(cand_sc_l, dim=1)
    cand_ay = torch.cat(cand_ay_l, dim=1)
    cand_ax = torch.cat(cand_ax_l, dim=1)
    lvl_map = _atlas_level_map(layout, dev)
    cand_lvl = torch.where(
        cand_sc > 0.0,
        lvl_map[cand_ay.clamp(0, h_all - 1), cand_ax.clamp(0, W - 1)],
        torch.full_like(cand_ay, -1))
    ays, axs, scores, octaves = [], [], [], []
    for lvl, budget in enumerate(budgets):
        if budget == 0:
            continue
        sc_l = torch.where(cand_lvl == lvl, cand_sc, torch.zeros_like(cand_sc))
        sc_top, ci = topk_stable(sc_l, budget)
        ays.append(torch.gather(cand_ay, 1, ci))
        axs.append(torch.gather(cand_ax, 1, ci))
        scores.append(sc_top)
        octaves.append(torch.full((B, budget), lvl, dtype=torch.int32,
                                  device=dev))
    score = torch.cat(scores, dim=1)
    return (torch.cat(ays, dim=1), torch.cat(axs, dim=1), score, score > 0.0,
            torch.cat(octaves, dim=1))
