"""FAST-9/16 corner scoring and atlas keypoint selection (port of
orb_slam3_vio_fixes_tpu/ops/fast.py).

`fast_score_batch` is the wrapper of kernel K1 (`csrc/fast_score.cu`), which
replaces the Pallas kernel `ops/pallas_kernels.py::fast_score_batch`: on a
CUDA tensor it launches the kernel, on a CPU tensor it runs the plain twin
`fast_score_plain` (the reference's `_fast_score_xla`). `fast_score` and
`detect` are the single-image entries: one image through the same wrapper
at B = 1, then the reference's two-tier threshold and per-cell selection.
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


def _arc_max(ring: torch.Tensor) -> torch.Tensor:
    """Max over the 16 circular 9-long arcs of the arc minimum, (16, ...) ->
    (...): the kernel's 3-ary chain over the ring wrapped to 24 entries,
    m3[i] = min3(ring[i..i+2]), m9[i] = min3(m3[i], m3[i+3], m3[i+6])."""
    rw = torch.cat([ring, ring[:ARC - 1]], dim=0)
    m3 = torch.minimum(torch.minimum(rw[0:22], rw[1:23]), rw[2:24])
    m9 = torch.minimum(torch.minimum(m3[0:16], m3[3:19]), m3[6:22])
    return m9.amax(dim=0)


def fast_score_plain(imgs: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9/16 arc score of (B, H, W) float32 images with integer-
    valued intensities (rounded half-to-even first). Intensities are held as
    int16, so this equals the integer arithmetic of the kernel and the
    reference's bf16 arithmetic bit for bit. As in the kernel, the centre c
    comes out of the chain: the bright score is max(arc_max(v), c) - c and
    the dark one max(arc_max(-v), -c) + c, over the ring values v."""
    _, h, w = imgs.shape
    x = torch.round(imgs.to(torch.float32))
    pad = F.pad(x[:, None], (BORDER,) * 4, mode="replicate")[:, 0].to(torch.int16)
    c = pad[:, BORDER:BORDER + h, BORDER:BORDER + w]
    ring = torch.stack([pad[:, BORDER + dy:BORDER + dy + h,
                            BORDER + dx:BORDER + dx + w] for dy, dx in CIRCLE])
    bright = torch.maximum(_arc_max(ring), c) - c
    dark = torch.maximum(_arc_max(-ring), -c) + c
    score = torch.maximum(bright, dark).to(torch.float32)
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
    kernels.count("fast_score")
    return out


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """Dense FAST score of one (H, W) float32 image with integer-valued
    intensities: K1 at B = 1 on a CUDA tensor, the plain twin on a CPU one.
    Border pixels are 0."""
    return fast_score_batch(img[None])[0]


def detect(img: torch.Tensor, threshold: float = 20.0, threshold_min: float = 7.0,
           cell: int = 35, max_per_cell: int = 4, budget: int = 256):
    """FAST keypoints of one (H, W) image with the two-tier threshold (a
    cell with a corner above `threshold` keeps only those, else its corners
    above `threshold_min`), 3x3 NMS, the top `max_per_cell` of each cell by
    iterated cell-max suppression (ties all kept), then the global top
    `budget` by score, ties in index order.

    Returns (idx (budget,) int32 flat indices y * W + x, score (budget,)
    float32, valid (budget,) bool)."""
    s = fast_score(img)[None]
    keep = nms3(s)
    strong = s > threshold
    weak = s > threshold_min
    cell_has_strong = _cell_pool_max(strong.to(torch.float32), cell) > 0.5
    admissible = keep & torch.where(cell_has_strong, strong, weak)
    zero = torch.zeros_like(s)
    sc = torch.where(admissible, s, zero)
    sc_work = sc
    selected = torch.zeros_like(admissible)
    for _ in range(max_per_cell):
        is_cell_best = (sc_work >= _cell_pool_max(sc_work, cell)) & (sc_work > 0.0)
        selected = selected | is_cell_best
        sc_work = torch.where(is_cell_best, zero, sc_work)
    final = torch.where(selected, sc, zero).reshape(-1)
    score, idx = topk_stable(final, budget)
    return idx.to(torch.int32), score, score > 0.0


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
