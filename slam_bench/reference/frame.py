"""Plain reference of the stereo frame build's feature stage: the pyramid
atlas, the FAST-9/16 arc score, the keypoint selection and steered BRIEF.

A frozen copy of the arithmetic that ORB-SLAM3's extractor defines and the
SLAM package's frame build follows (atlas of 8 levels at scale 1.2 with
half-pixel antialiased bilinear resizes, FAST with the two-tier threshold
20 / 7 and 3x3 non-maximum suppression, 4 per 35-pixel cell, per-level
budgets, orientation by intensity centroid over a 31-pixel circle, 256
BRIEF pairs of the G-II pattern quantised to 64 rotation bins), in plain
PyTorch. It imports nothing of the SLAM package; every table is built here.
The moments are summed in float64, where every bf16 x integer product and
their sum are exact.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
          (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))
BORDER = 3
HALF_PATCH = 15
PATCH_R = 16
PATCH = 2 * PATCH_R + 1
N_BINS = 64
DETECT_BORDER = 16


# -- pyramid atlas --

def pyramid_shapes(h, w, n_levels, scale):
    return [(int(round(h / scale**lvl)), int(round(w / scale**lvl))) for lvl in range(n_levels)]


@functools.lru_cache(maxsize=None)
def atlas_layout(h, w, n_levels, scale, align=35, gap=8):
    """(offsets, heights, widths, total_h): levels stacked vertically, each
    offset a multiple of the cell size, `gap` blank rows between levels."""
    offs, hs, ws = [], [], []
    y = 0
    for lh, lw in pyramid_shapes(h, w, n_levels, scale):
        offs.append(y)
        hs.append(lh)
        ws.append(lw)
        y = ((y + lh + gap + align - 1) // align) * align
    return tuple(offs), tuple(hs), tuple(ws), y


def atlas(imgs: torch.Tensor, n_levels: int, scale: float, cell: int) -> torch.Tensor:
    """(B, H, W) grey images -> (B, total_h, W) float32 atlases, each level
    a half-pixel antialiased bilinear resize of the previous one."""
    imgs = imgs.to(torch.float32)
    b, h, w = imgs.shape
    offs, hs, ws, total = atlas_layout(h, w, n_levels, scale, cell)
    out = torch.zeros((b, total, w), dtype=torch.float32, device=imgs.device)
    lv = imgs
    for lvl, (off, lh, lw) in enumerate(zip(offs, hs, ws)):
        if lvl:
            lv = F.interpolate(lv[:, None], size=(lh, lw), mode="bilinear",
                               align_corners=False, antialias=True)[:, 0]
        out[:, off:off + lh, :lw] = lv
    return out


# -- FAST --

def _arc_max(ring):
    rw = torch.cat([ring, ring[:8]], dim=0)
    best = None
    for i in range(16):
        m = rw[i]
        for j in range(1, 9):
            m = torch.minimum(m, rw[i + j])
        best = m if best is None else torch.maximum(best, m)
    return best


def fast_score(imgs: torch.Tensor) -> torch.Tensor:
    """FAST-9/16 score of (B, H, W) images, intensities rounded half to even:
    the largest t for which 9 contiguous ring pixels are all brighter than
    centre + t or all darker than centre - t (0 when none), 0 within 3
    pixels of the border."""
    _, h, w = imgs.shape
    x = torch.round(imgs.to(torch.float32))
    pad = F.pad(x[:, None], (BORDER,) * 4, mode="replicate")[:, 0].to(torch.int32)
    c = pad[:, BORDER:BORDER + h, BORDER:BORDER + w]
    ring = torch.stack([pad[:, BORDER + dy:BORDER + dy + h, BORDER + dx:BORDER + dx + w]
                        for dy, dx in CIRCLE])
    bright = (_arc_max(ring) - c).clamp(min=0)
    dark = (c + _arc_max(-ring)).clamp(min=0)
    score = torch.maximum(bright, dark).to(torch.float32)
    yy = torch.arange(h, device=imgs.device)[:, None]
    xx = torch.arange(w, device=imgs.device)[None, :]
    inb = (yy >= BORDER) & (yy < h - BORDER) & (xx >= BORDER) & (xx < w - BORDER)
    return torch.where(inb[None], score, torch.zeros_like(score))


# -- keypoint selection --

def features_per_level(n_features, n_levels, scale):
    inv = 1.0 / scale
    n0 = n_features * (1 - inv) / (1 - inv**n_levels)
    per = [int(round(n0 * inv**i)) for i in range(n_levels)]
    per[-1] = max(n_features - sum(per[:-1]), 0)
    return per


def _nms3(s):
    _, h, w = s.shape
    p = F.pad(s, (1, 1, 1, 1), value=-1.0)
    neigh = torch.stack([p[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)
                         if (dy, dx) != (1, 1)])
    return s >= neigh.amax(dim=0)


def _cell_max(x, cell):
    b, h, w = x.shape
    ph, pw = (-h) % cell, (-w) % cell
    xp = F.pad(x, (0, pw, 0, ph), value=-float("inf"))
    hc, wc = (h + ph) // cell, (w + pw) // cell
    pooled = xp.reshape(b, hc, cell, wc, cell).amax(dim=(2, 4))
    return pooled.repeat_interleave(cell, 1).repeat_interleave(cell, 2)[:, :h, :w]


def select(score, shape, orb: dict):
    """Keypoints of (B, total_h, W) atlas scores: the interior of each level
    (16-pixel border), 3x3 NMS, the two-tier threshold per 35-pixel cell,
    the first-index argmax 4 times per cell, then each level's top budget
    by score with ties in candidate order. Returns (ay, ax, valid, octave),
    (B, n_features) each, ay / ax in atlas pixels."""
    h, w = shape
    n_levels, scale, cell = orb["nLevels"], orb["scaleFactor"], 35
    offs, hs, ws, total = atlas_layout(h, w, n_levels, scale, cell)
    dev = score.device
    lvl_map = torch.full((total, w), -1, dtype=torch.int64, device=dev)
    interior = torch.zeros((total, w), dtype=torch.bool, device=dev)
    for lvl, (off, lh, lw) in enumerate(zip(offs, hs, ws)):
        lvl_map[off:off + lh, :lw] = lvl
        if lh > 2 * DETECT_BORDER and lw > 2 * DETECT_BORDER:
            interior[off + DETECT_BORDER:off + lh - DETECT_BORDER,
                     DETECT_BORDER:lw - DETECT_BORDER] = True
    s = torch.where(interior[None], score, torch.zeros_like(score))
    strong, weak = s > orb["iniThFAST"], s > orb["minThFAST"]
    has_strong = _cell_max(strong.to(torch.float32), cell) > 0.5
    sc = torch.where(_nms3(s) & torch.where(has_strong, strong, weak), s, torch.zeros_like(s))
    B = sc.shape[0]
    hc, wc = -(-total // cell), -(-w // cell)
    cells = F.pad(sc, (0, wc * cell - w, 0, hc * cell - total)).reshape(
        B, hc, cell, wc, cell).permute(0, 1, 3, 2, 4).reshape(B, hc, wc, cell * cell)
    cy = torch.arange(hc, device=dev)[:, None]
    cx = torch.arange(wc, device=dev)[None, :]
    ar = torch.arange(cell * cell, device=dev)
    c_sc, c_ay, c_ax = [], [], []
    for _ in range(4):
        j = torch.argmax(cells, dim=-1)
        c_sc.append(torch.take_along_dim(cells, j[..., None], dim=-1)[..., 0].reshape(B, -1))
        c_ay.append((cy * cell + j // cell).reshape(B, -1))
        c_ax.append((cx * cell + j % cell).reshape(B, -1))
        cells = torch.where(ar == j[..., None], torch.zeros_like(cells), cells)
    c_sc, c_ay, c_ax = torch.cat(c_sc, 1), torch.cat(c_ay, 1), torch.cat(c_ax, 1)
    c_lvl = torch.where(c_sc > 0, lvl_map[c_ay.clamp(0, total - 1), c_ax.clamp(0, w - 1)],
                        torch.full_like(c_ay, -1))
    ays, axs, scs, octs = [], [], [], []
    for lvl, budget in enumerate(features_per_level(orb["nFeatures"], n_levels, scale)):
        if budget == 0:
            continue
        sl = torch.where(c_lvl == lvl, c_sc, torch.zeros_like(c_sc))
        top, ci = torch.sort(sl, dim=-1, descending=True, stable=True)
        top, ci = top[:, :budget], ci[:, :budget]
        ays.append(torch.gather(c_ay, 1, ci))
        axs.append(torch.gather(c_ax, 1, ci))
        scs.append(top)
        octs.append(torch.full((B, budget), lvl, dtype=torch.int32, device=dev))
    sc_all = torch.cat(scs, 1)
    return torch.cat(ays, 1), torch.cat(axs, 1), sc_all > 0, torch.cat(octs, 1)


def keypoint_uv(ay, ax, octave, shape, orb: dict):
    """Level-0 pixel coordinates (x, y) of atlas keypoints, float32."""
    h, w = shape
    offs, *_ = atlas_layout(h, w, orb["nLevels"], orb["scaleFactor"], 35)
    off = torch.as_tensor(np.asarray(offs, np.float32), device=ay.device)[octave.long()]
    s = torch.as_tensor(np.asarray([orb["scaleFactor"]**i for i in range(orb["nLevels"])],
                                   np.float32), device=ay.device)[octave.long()]
    return torch.stack([ax.to(torch.float32) * s, (ay.to(torch.float32) - off) * s], -1)


# -- orientation and steered BRIEF --

def blur(img: torch.Tensor) -> torch.Tensor:
    """7-tap Gaussian (sigma 2) of (B, H, W), separable, reflect-101 borders,
    taps normalised in float32, accumulated tap by tap in float32."""
    x = np.arange(7, dtype=np.float32) - np.float32(3.0)
    k = np.exp(np.float32(-0.5) * (x / np.float32(2.0)) ** 2).astype(np.float32)
    k = [float(v) for v in (k / k.sum(dtype=np.float32)).astype(np.float32)]
    _, h, w = img.shape
    p = F.pad(img[:, None], (0, 0, 3, 3), mode="reflect")[:, 0]
    acc = k[0] * p[:, 0:h]
    for i in range(1, 7):
        acc = acc + k[i] * p[:, i:i + h]
    p = F.pad(acc[:, None], (3, 3, 0, 0), mode="reflect")[:, 0]
    acc = k[0] * p[:, :, 0:w]
    for i in range(1, 7):
        acc = acc + k[i] * p[:, :, i:i + w]
    return acc


@functools.lru_cache(maxsize=None)
def brief_pattern():
    """(256, 4) (x1, y1, x2, y2): Gaussian G-II pairs, seed 1234, 31-pixel patch."""
    rng = np.random.default_rng(1234)
    p1 = np.clip(np.round(rng.normal(0.0, 31 / 5.0, size=(256, 2))), -15, 15)
    p2 = np.clip(np.round(p1 + rng.normal(0.0, 31 / 10.0, size=(256, 2))), -15, 15)
    same = np.all(p1 == p2, axis=1)
    p2[same, 0] = np.where(p2[same, 0] < 15, p2[same, 0] + 1, p2[same, 0] - 1)
    return np.concatenate([p1, p2], axis=1)


@functools.lru_cache(maxsize=None)
def brief_offsets():
    """(64, 256, 2) flat patch offsets of each pair rotated to each bin's
    centre angle, rounded and clamped into the 33 x 33 patch."""
    pat = brief_pattern()
    out = np.zeros((N_BINS, 256, 2), np.int64)
    for b in range(N_BINS):
        a = (b + 0.5) / N_BINS * 2.0 * np.pi - np.pi
        ca, sa = np.cos(a), np.sin(a)
        for s in range(256):
            x1, y1, x2, y2 = pat[s]
            pts = []
            for x, y in ((x1, y1), (x2, y2)):
                rx = min(max(int(round(ca * x - sa * y)) + PATCH_R, 0), PATCH - 1)
                ry = min(max(int(round(sa * x + ca * y)) + PATCH_R, 0), PATCH - 1)
                pts.append(ry * PATCH + rx)
            out[b, s] = pts
    return out


@functools.lru_cache(maxsize=None)
def moment_weights():
    """(PATCH * PATCH, 2) float64 weights of m01 (dy) and m10 (dx) over the
    31-pixel circle centred in the patch."""
    yy, xx = np.mgrid[-PATCH_R:PATCH_R + 1, -PATCH_R:PATCH_R + 1]
    circle = (xx * xx + yy * yy <= HALF_PATCH * HALF_PATCH)
    return np.stack([(circle * yy).reshape(-1), (circle * xx).reshape(-1)], 1).astype(np.float64)


def patches(img: torch.Tensor, ay, ax):
    """(B, K, PATCH * PATCH) patches of (B, H, W) at integer centres, from
    an edge-replicated copy."""
    B, H, W = img.shape
    pad = F.pad(img[:, None].to(torch.float32), (PATCH_R,) * 4, mode="replicate")[:, 0]
    pad = pad.to(img.dtype)
    Wp = W + 2 * PATCH_R
    yy, xx = np.mgrid[0:PATCH, 0:PATCH]
    off = torch.as_tensor((yy * Wp + xx).reshape(-1), device=img.device)
    idx = (ay.to(torch.int64) * Wp + ax.to(torch.int64))[..., None] + off
    return torch.gather(pad.reshape(B, -1), 1, idx.reshape(B, -1)).reshape(B, ay.shape[1], -1)


def orientation(p: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle atan2(m01, m10), moments summed in float64."""
    w = torch.as_tensor(moment_weights(), device=p.device)
    m = p.to(torch.float64) @ w
    return torch.atan2(m[..., 0], m[..., 1]).to(torch.float32)


def describe(p: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool steered BRIEF bits: first sample < second, the pairs
    rotated to the angle's bin."""
    b = torch.remainder(torch.floor((angle + math.pi) / (2.0 * math.pi) * N_BINS)
                        .to(torch.int64), N_BINS)
    sel = torch.as_tensor(brief_offsets(), device=p.device)[b]
    v = torch.gather(p.reshape(-1, p.shape[-1]), 1, sel.reshape(-1, 512)).reshape(-1, 256, 2)
    return (v[..., 0] < v[..., 1]).reshape(angle.shape + (256,))


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 words -> (..., 256) bool, bit s of word k is bit 32k + s."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int64)
    bits = (desc.to(torch.int64)[..., None] >> shifts) & 1
    return bits.bool().reshape(desc.shape[:-1] + (256,))
