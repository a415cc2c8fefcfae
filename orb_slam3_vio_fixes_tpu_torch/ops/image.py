"""Image-space ops: pyramid atlas, Gaussian blur, bilinear resize (port of
orb_slam3_vio_fixes_tpu/ops/image.py).

Images are float32 with a leading batch axis (B, H, W): left and right eyes
go through every op together.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float):
    return [(int(round(h / scale**lvl)), int(round(w / scale**lvl)))
            for lvl in range(n_levels)]


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B, H, W) bilinear resize with half-pixel centres and antialiasing on
    downsampling — what jax.image.resize(method="linear") computes. Without
    `antialias` the pyramid differs from the reference by tens of gray
    levels."""
    return F.interpolate(img[:, None], size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=True)[:, 0]


def gaussian_kernel1d(ksize: int, sigma: float) -> list[float]:
    """Normalised taps, computed in float32 like the reference."""
    r = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float32) - np.float32(r)
    k = np.exp(np.float32(-0.5) * (x / np.float32(sigma)) ** 2).astype(np.float32)
    return [float(v) for v in (k / k.sum(dtype=np.float32)).astype(np.float32)]


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur of (B, H, W) with reflect-101 padding, as
    shifted adds in float32 (a cuDNN convolution would round through TF32 by
    default and move FAST/BRIEF inputs)."""
    k = gaussian_kernel1d(ksize, sigma)
    pad = ksize // 2
    _, h, w = img.shape
    x = F.pad(img[:, None], (0, 0, pad, pad), mode="reflect")[:, 0]
    acc = k[0] * x[:, 0:h]
    for i in range(1, ksize):
        acc = acc + k[i] * x[:, i:i + h]
    x = F.pad(acc[:, None], (pad, pad, 0, 0), mode="reflect")[:, 0]
    acc = k[0] * x[:, :, 0:w]
    for i in range(1, ksize):
        acc = acc + k[i] * x[:, :, i:i + w]
    return acc


def build_pyramid(img: torch.Tensor, n_levels: int = 8, scale: float = 1.2):
    """Per-level images, each a resize of the previous level."""
    _, h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale)
    levels = [img]
    for lvl in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], *shapes[lvl]))
    return levels


@functools.lru_cache(maxsize=None)
def scale_factors(n_levels: int = 8, scale: float = 1.2, device=None) -> torch.Tensor:
    """(n_levels,) float32 scale^level. Cached per device (read-only): a
    fresh host->device copy per call would synchronise the stream."""
    return torch.tensor([scale**i for i in range(n_levels)], dtype=torch.float32,
                        device=device)


class AtlasLayout(tuple):
    """Static pyramid-atlas layout: all levels stacked vertically in one
    canvas (offsets, heights, widths, total_h, width)."""

    __slots__ = ()

    def __new__(cls, offsets, heights, widths, total_h, width):
        return tuple.__new__(cls, (offsets, heights, widths, total_h, width))

    offsets = property(lambda s: s[0])
    heights = property(lambda s: s[1])
    widths = property(lambda s: s[2])
    total_h = property(lambda s: s[3])
    width = property(lambda s: s[4])


@functools.lru_cache(maxsize=None)
def atlas_layout(h: int, w: int, n_levels: int, scale: float,
                 align: int = 35, gap: int = 8) -> AtlasLayout:
    """Row offsets aligned to the FAST cell size; `gap` blank rows isolate
    NMS/blur across level boundaries."""
    offs, hs, ws = [], [], []
    y = 0
    for lh, lw in pyramid_shapes(h, w, n_levels, scale):
        offs.append(y)
        hs.append(lh)
        ws.append(lw)
        y = ((y + lh + gap + align - 1) // align) * align
    return AtlasLayout(tuple(offs), tuple(hs), tuple(ws), y, w)


def build_pyramid_atlas(imgs: torch.Tensor, n_levels: int, scale: float,
                        layout: AtlasLayout) -> torch.Tensor:
    """(B, total_h, W) float32 canvases with each level pasted at its offset
    (zeros elsewhere)."""
    imgs = imgs.to(torch.float32)
    levels = build_pyramid(imgs, n_levels, scale)
    canvas = torch.zeros((imgs.shape[0], layout.total_h, layout.width),
                         dtype=torch.float32, device=imgs.device)
    for lv, off, lh, lw in zip(levels, layout.offsets, layout.heights,
                               layout.widths):
        canvas[:, off:off + lh, :lw] = lv
    return canvas
