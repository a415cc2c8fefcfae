"""ORB extraction: oriented multi-scale FAST + steered BRIEF (port of
orb_slam3_vio_fixes_tpu/ops/orb.py).

The fixed tables (BRIEF pattern, moment weights, binned BRIEF offsets) come
from the same numpy code as the reference, so both packages hold identical
tables. The reference computes all 64 rotation bins as one (K, 1089) x
(1089, 16384) bf16 matmul and keeps one bin; each column of that matrix has
one +1 and one -1, so gathering each keypoint's 256 binned pairs from the
same table gives exactly the same bits.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from orb_slam3_vio_fixes_tpu_torch.ops import fast as fast_ops
from orb_slam3_vio_fixes_tpu_torch.ops import image as image_ops

HALF_PATCH = 15
PATCH_R = 16
PATCH = 2 * PATCH_R + 1  # 33
N_ANGLE_BINS = 64


class ORBConfig(NamedTuple):
    n_features: int = 1200
    n_levels: int = 8
    scale: float = 1.2
    fast_threshold: float = 20.0
    fast_threshold_min: float = 7.0
    cell: int = 35
    max_per_cell: int = 4


class Features(NamedTuple):
    """Fixed-capacity features, batched (B, N, ...): uv (N, 2), response,
    octave int32, angle, desc (N, 8) int32 bit patterns, valid."""

    uv: torch.Tensor
    response: torch.Tensor
    octave: torch.Tensor
    angle: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor


def features_per_level(cfg: ORBConfig) -> list[int]:
    inv = 1.0 / cfg.scale
    n0 = cfg.n_features * (1 - inv) / (1 - inv**cfg.n_levels)
    per = [int(round(n0 * inv**i)) for i in range(cfg.n_levels)]
    per[-1] = max(cfg.n_features - sum(per[:-1]), 0)
    return per


@functools.lru_cache(maxsize=None)
def brief_pattern(seed: int = 1234, n_bits: int = 256, patch: int = 31) -> np.ndarray:
    """(n_bits, 4) int32 (x1, y1, x2, y2): BRIEF G-II Gaussian pairs."""
    rng = np.random.default_rng(seed)
    s = patch
    half = patch // 2
    p1 = np.clip(np.round(rng.normal(0.0, s / 5.0, size=(n_bits, 2))), -half, half)
    p2 = np.clip(np.round(p1 + rng.normal(0.0, s / 10.0, size=(n_bits, 2))),
                 -half, half)
    same = np.all(p1 == p2, axis=1)
    p2[same, 0] = np.where(p2[same, 0] < half, p2[same, 0] + 1, p2[same, 0] - 1)
    return np.concatenate([p1, p2], axis=1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _circular_mask(radius: int = HALF_PATCH) -> np.ndarray:
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return (x * x + y * y <= radius * radius).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _moment_matrix() -> np.ndarray:
    """(PATCH*PATCH, 2): column 0 = dy (m01), column 1 = dx (m10) over the
    central 31x31 circle."""
    mask = np.zeros((PATCH, PATCH), np.float32)
    c0 = PATCH_R - HALF_PATCH
    mask[c0:c0 + 2 * HALF_PATCH + 1, c0:c0 + 2 * HALF_PATCH + 1] = _circular_mask()
    coords = np.arange(-PATCH_R, PATCH_R + 1, dtype=np.float32)
    ky = (mask * coords[:, None]).reshape(-1)
    kx = (mask * coords[None, :]).reshape(-1)
    return np.stack([ky, kx], axis=1)


@functools.lru_cache(maxsize=None)
def brief_bin_offsets(n_bins: int = N_ANGLE_BINS) -> np.ndarray:
    """(n_bins, 256, 2) int64 flat patch indices of the first and second
    sample of every rotated BRIEF pair — the +1 / -1 rows of the reference's
    _brief_diff_matrix, derived by the same rounding and clamping."""
    pat = brief_pattern().astype(np.float64)
    out = np.zeros((n_bins, 256, 2), np.int64)
    for b in range(n_bins):
        a = (b + 0.5) / n_bins * 2.0 * np.pi - np.pi
        ca, sa = np.cos(a), np.sin(a)
        for s in range(256):
            x1, y1, x2, y2 = pat[s]
            rx1 = min(max(int(round(ca * x1 - sa * y1)) + PATCH_R, 0), PATCH - 1)
            ry1 = min(max(int(round(sa * x1 + ca * y1)) + PATCH_R, 0), PATCH - 1)
            rx2 = min(max(int(round(ca * x2 - sa * y2)) + PATCH_R, 0), PATCH - 1)
            ry2 = min(max(int(round(sa * x2 + ca * y2)) + PATCH_R, 0), PATCH - 1)
            out[b, s] = (ry1 * PATCH + rx1, ry2 * PATCH + rx2)
    return out


@functools.lru_cache(maxsize=None)
def _device_table(name: str, device, *args) -> torch.Tensor:
    """The fixed tables on a device, copied once (read-only): a host->device
    copy inside the frame loop would synchronise the stream."""
    if name == "moment":
        return torch.as_tensor(_moment_matrix(), device=device)
    if name == "brief":
        return torch.as_tensor(brief_bin_offsets(), device=device)
    if name == "patch":                 # flat offsets in a row of width args[0]
        yy, xx = np.mgrid[0:PATCH, 0:PATCH]
        return torch.as_tensor((yy * args[0] + xx).reshape(-1), device=device)
    if name == "level_offset_scale":    # per-keypoint atlas row offset, scale
        layout, budgets, scale = args
        used = [lvl for lvl, b in enumerate(budgets) if b > 0]
        reps = [budgets[lvl] for lvl in used]
        return torch.as_tensor(np.stack([
            np.repeat([layout.offsets[lvl] for lvl in used], reps),
            np.repeat([scale**lvl for lvl in used], reps)]).astype(np.float32),
            device=device)
    raise KeyError(name)


def _gather_patches(img: torch.Tensor, ay: torch.Tensor, ax: torch.Tensor):
    """(B, K, PATCH*PATCH) patches of (B, H, W) centred at integer (ay, ax)
    from an edge-padded copy of img."""
    B, H, W = img.shape
    padded = F.pad(img[:, None].to(torch.float32), (PATCH_R,) * 4,
                   mode="replicate")[:, 0].to(img.dtype)
    Wp = W + 2 * PATCH_R
    flat_off = _device_table("patch", img.device, Wp)           # (P,)
    base = ay.to(torch.int64) * Wp + ax.to(torch.int64)         # (B, K)
    idx = base[..., None] + flat_off                            # (B, K, P)
    return torch.gather(padded.reshape(B, -1), 1,
                        idx.reshape(B, -1)).reshape(B, ay.shape[1], -1)


def _orientation(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle from bf16 patches (..., P). The products of
    bf16 values with the integer moment weights are exact in float32; only
    the summation order can differ from the reference's dot."""
    m = patches.to(torch.float32) @ _device_table("moment", patches.device)
    return torch.atan2(m[..., 0], m[..., 1])


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool -> (..., 8) int32 bit patterns (bit s of word w is
    bit 32 w + s)."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (bits.reshape(bits.shape[:-1] + (8, 32)).to(torch.int64)
             << shifts).sum(-1)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def _describe(patches: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF with the rotation quantised to N_ANGLE_BINS, the
    reference's _describe_mm semantics: bit = (first sample < second)."""
    n_bins = N_ANGLE_BINS
    bin_idx = torch.remainder(torch.floor(
        (angle + math.pi) / (2.0 * math.pi) * n_bins).to(torch.int64), n_bins)
    sel = _device_table("brief", patches.device)[bin_idx]   # (..., 256, 2)
    lead = patches.shape[:-1]
    flat = patches.reshape(-1, patches.shape[-1])
    sel = sel.reshape(-1, 256 * 2)
    v = torch.gather(flat, 1, sel).reshape(-1, 256, 2)
    bits = v[..., 0] < v[..., 1]
    return pack_bits(bits).reshape(lead + (8,))


def extract_batch(imgs: torch.Tensor, cfg: ORBConfig) -> Features:
    """(B, H, W) images -> batched Features (B, n_features, ...): pyramid
    atlas, FAST score (kernel K1), selection, blur, patch gather,
    orientation and steered BRIEF."""
    _, h, w = imgs.shape
    layout = image_ops.atlas_layout(h, w, cfg.n_levels, cfg.scale,
                                    align=cfg.cell)
    atlases = image_ops.build_pyramid_atlas(imgs, cfg.n_levels, cfg.scale, layout)
    scores = fast_ops.fast_score_batch(atlases)
    budgets = tuple(features_per_level(cfg))
    return _describe_atlas(atlases, scores, layout, budgets, cfg)


def extract(img: torch.Tensor, cfg: ORBConfig = ORBConfig()) -> Features:
    """ORB features of one (H, W) float32 image: a B = 1 atlas through
    `extract_batch` (K1 on a CUDA tensor)."""
    f = extract_batch(img[None], cfg)
    return Features(*(a[0] for a in f))


def _describe_atlas(atlas, score_img, layout, budgets, cfg: ORBConfig) -> Features:
    ay, ax, score, valid, octave = fast_ops.detect_atlas_from_score(
        score_img, layout, budgets, threshold=cfg.fast_threshold,
        threshold_min=cfg.fast_threshold_min, cell=cfg.cell,
        max_per_cell=cfg.max_per_cell)
    # one bf16 patch gather from the blurred atlas serves orientation and
    # description, as in the reference
    blurred = image_ops.gaussian_blur(atlas).to(torch.bfloat16)
    patches = _gather_patches(blurred, ay, ax)
    angle = _orientation(patches)
    desc = _describe(patches, angle)
    off_kp, s_kp = _device_table("level_offset_scale", atlas.device, layout,
                                 budgets, cfg.scale)
    uv = torch.stack([ax.to(torch.float32) * s_kp,
                      (ay.to(torch.float32) - off_kp) * s_kp], dim=-1)
    return Features(uv=uv, response=score, octave=octave, angle=angle,
                    desc=desc, valid=valid)


def extract_pair(img_l: torch.Tensor, img_r: torch.Tensor,
                 cfg: ORBConfig = ORBConfig()):
    """Both eyes through one batched extraction."""
    f = extract_batch(torch.stack([img_l, img_r]), cfg)
    return (Features(*(a[0] for a in f)), Features(*(a[1] for a in f)))
