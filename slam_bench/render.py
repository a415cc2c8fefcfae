"""Textured-sprite stereo renderer of the benchmark's scenes.

The world is a cloud of square sprites with a 12 x 12 random texture each,
drawn by a camera model (`slam_bench/cameras/<model>.py`; the EuRoC
cells use the ideal pin-hole) in painter's order (far first): a sprite
has the model's half-size (pin-hole: size * fx / z), at least 2 pixels,
around the projection of its centre, covers the pixels whose texture coordinate falls
inside the texture, and is sampled bilinearly at float coordinates. Sprites
with z <= 0.3 m are not drawn. These are the semantics of the textured
sprites that the SLAM package's synthetic scenes use.

`render_many` is the vectorised PyTorch renderer that makes the scenes on
the card, many poses in one call: each visible (pose, sprite) pair's pixel
window is enumerated, the nearest sprite per pixel is found with one
`amin` scatter of a (depth bits, pair) key, and the winners' texels are
gathered per pixel. `render_numpy` is its plain twin, the painter's loop
in float32, for the CPU tests.
"""

from __future__ import annotations

import functools
import importlib
from typing import NamedTuple

import numpy as np
import torch

TEX = 12
Z_NEAR = 0.3
MIN_HALF = 2.0
BACKGROUND = 60.0
PAIRS_PER_CHUNK = 1 << 23


class World(NamedTuple):
    points: torch.Tensor     # (M, 3) float32 sprite centres
    size: torch.Tensor       # (M,) float32 half-size in metres
    tex: torch.Tensor        # (M, TEX, TEX) float32 texture


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    model: str = "pinhole"       # a module slam_bench/cameras/<model>.py
    params: tuple = ()           # the model's further coefficients


def camera(c: dict) -> Camera:
    """The Camera of a configuration's camera block."""
    return Camera(c["fx"], c["fy"], c["cx"], c["cy"], c["width"], c["height"],
                  c.get("model", "pinhole"), tuple(c.get("params", ())))


@functools.lru_cache(maxsize=None)
def model(name: str):
    """The projection module `slam_bench/cameras/<name>.py`: its
    `project(x, y, z, size, cam, xp)` gives a point's pixel (u, v) and the
    half-size in pixels of a sprite of half-size `size` metres there."""
    return importlib.import_module(f"slam_bench.cameras.{name}")


def f32(x) -> float:
    """A Python float that holds a float32 value exactly, so that torch and
    numpy scale by the same number."""
    return float(np.float32(x))


def _project(P, R_cw, t_cw, size, cam: Camera):
    """Per-sprite float32 camera depth z, projected centre (u, v), half-size,
    top-left corner (u0f, v0f) and side; works on torch tensors and numpy
    arrays, and broadcasts over leading pose axes."""
    xp = torch if isinstance(P, torch.Tensor) else np
    Xc = [P[..., 0] * R_cw[k][0] + P[..., 1] * R_cw[k][1] + P[..., 2] * R_cw[k][2] + t_cw[k]
          for k in range(3)]
    z = Xc[2]
    u, v, half = model(cam.model).project(Xc[0], Xc[1], z, size, cam, xp)
    half = xp.where(half < MIN_HALF, xp.full_like(half, MIN_HALF), half)
    return z, u, v, half, u - half, v - half, 2.0 * half


def _texels(tex_flat, sid, tx, ty):
    """Bilinear texel of sprites `sid` at texture coordinates (tx, ty)."""
    xp = torch if isinstance(tx, torch.Tensor) else np
    hi = TEX - 1 - 1e-4
    if xp is torch:
        txc, tyc = tx.clamp(0.0, hi), ty.clamp(0.0, hi)
        x0, y0 = txc.to(torch.int64), tyc.to(torch.int64)
        ax, ay = txc - x0.to(torch.float32), tyc - y0.to(torch.float32)
    else:
        txc = np.clip(tx, np.float32(0.0), np.float32(hi))
        tyc = np.clip(ty, np.float32(0.0), np.float32(hi))
        x0, y0 = txc.astype(np.int64), tyc.astype(np.int64)
        ax, ay = txc - x0.astype(np.float32), tyc - y0.astype(np.float32)
    base = sid * (TEX * TEX)
    t00 = tex_flat[base + y0 * TEX + x0]
    t01 = tex_flat[base + y0 * TEX + x0 + 1]
    t10 = tex_flat[base + (y0 + 1) * TEX + x0]
    t11 = tex_flat[base + (y0 + 1) * TEX + x0 + 1]
    one = 1.0 if xp is torch else np.float32(1.0)
    return (t00 * (one - ay) * (one - ax) + t01 * (one - ay) * ax
            + t10 * ay * (one - ax) + t11 * ay * ax)


def render_many(world: World, cam: Camera, R_cw, t_cw) -> torch.Tensor:
    """(B, H, W) float32 images of `world` seen from the B camera poses
    (R_cw (B, 3, 3), t_cw (B, 3): world -> camera), on the world's device.
    Every (pose, sprite) pair is a row; rows are drawn together."""
    dev = world.points.device
    h, w = cam.height, cam.width
    R = torch.as_tensor(np.asarray(R_cw, np.float32), device=dev)[:, None]      # (B, 1, 3, 3)
    t = torch.as_tensor(np.asarray(t_cw, np.float32), device=dev)[:, None]      # (B, 1, 3)
    B, M = R.shape[0], world.points.shape[0]
    z, u, v, half, u0f, v0f, side = (a.reshape(-1) for a in _project(
        world.points[None], [[R[..., i, j] for j in range(3)] for i in range(3)],
        [t[..., i] for i in range(3)], world.size[None], cam))
    cu0 = torch.floor(u0f).clamp(min=0)
    cu1 = (torch.ceil(u + half) + 1).clamp(max=w)
    cv0 = torch.floor(v0f).clamp(min=0)
    cv1 = (torch.ceil(v + half) + 1).clamp(max=h)
    keep = (z > Z_NEAR) & (cu1 > cu0) & (cv1 > cv0)
    rid = torch.nonzero(keep)[:, 0]
    key = torch.full((B * h * w,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=dev)
    if rid.numel():
        cu0, cu1, cv0, cv1 = (a[rid].to(torch.int64) for a in (cu0, cu1, cv0, cv1))
        base = (rid // M) * (h * w)
        extent = torch.maximum(cu1 - cu0, cv1 - cv0)
        # buckets of window sides by powers of two: pairs ~ sprites x side^2
        bucket = torch.ceil(torch.log2(extent.to(torch.float32).clamp(min=8))).to(torch.int64)
        zkey = z[rid].view(torch.int32).to(torch.int64) << 32 | rid
        for b in torch.unique(bucket).tolist():
            sel = torch.nonzero(bucket == b)[:, 0]
            side_b = 1 << b
            per = max(1, PAIRS_PER_CHUNK // (side_b * side_b))
            ar = torch.arange(side_b, device=dev)
            for c0 in range(0, sel.numel(), per):
                s = sel[c0:c0 + per]
                g = rid[s]
                px = cu0[s, None, None] + ar[None, None, :]
                py = cv0[s, None, None] + ar[None, :, None]
                tx = (px.to(torch.float32) - u0f[g, None, None]) / side[g, None, None] * (TEX - 1)
                ty = (py.to(torch.float32) - v0f[g, None, None]) / side[g, None, None] * (TEX - 1)
                inside = ((px < cu1[s, None, None]) & (py < cv1[s, None, None])
                          & (tx >= 0) & (tx <= TEX - 1) & (ty >= 0) & (ty <= TEX - 1))
                pix = (base[s, None, None] + py * w + px)[inside]
                k = zkey[s, None, None].expand(inside.shape)[inside]
                key.scatter_reduce_(0, pix, k, reduce="amin")
    img = torch.full((B * h * w,), BACKGROUND, dtype=torch.float32, device=dev)
    hit = torch.nonzero(key != torch.iinfo(torch.int64).max)[:, 0]
    if hit.numel():
        g = key[hit] & 0xFFFFFFFF
        px = (hit % w).to(torch.float32)
        py = ((hit // w) % h).to(torch.float32)
        tx = (px - u0f[g]) / side[g] * (TEX - 1)
        ty = (py - v0f[g]) / side[g] * (TEX - 1)
        img[hit] = _texels(world.tex.reshape(-1), g % M, tx, ty)
    return img.reshape(B, h, w)


def render_numpy(points, size, tex, cam: Camera, R_cw, t_cw) -> np.ndarray:
    """Plain twin of `render_many` for one pose: the painter's loop over the
    sprites, far first, in float32 on numpy arrays."""
    h, w = cam.height, cam.width
    R = [[np.float32(R_cw[i][j]) for j in range(3)] for i in range(3)]
    t = [np.float32(t_cw[i]) for i in range(3)]
    points = np.asarray(points, np.float32)
    size = np.asarray(size, np.float32)
    tex_flat = np.asarray(tex, np.float32).reshape(-1)
    z, u, v, half, u0f, v0f, side = _project(points, R, t, size, cam)
    img = np.full((h, w), np.float32(BACKGROUND), np.float32)
    for i in np.argsort(-z, kind="stable"):
        if not z[i] > Z_NEAR:
            continue
        cu0, cu1 = max(int(np.floor(u0f[i])), 0), min(int(np.ceil(u[i] + half[i])) + 1, w)
        cv0, cv1 = max(int(np.floor(v0f[i])), 0), min(int(np.ceil(v[i] + half[i])) + 1, h)
        if cu1 <= cu0 or cv1 <= cv0:
            continue
        uu = np.arange(cu0, cu1, dtype=np.float32)
        vv = np.arange(cv0, cv1, dtype=np.float32)
        tx = (uu - u0f[i]) / side[i] * np.float32(TEX - 1)
        ty = (vv - v0f[i]) / side[i] * np.float32(TEX - 1)
        inside = (((ty >= 0) & (ty <= TEX - 1))[:, None]
                  & ((tx >= 0) & (tx <= TEX - 1))[None, :])
        TX = np.broadcast_to(tx[None, :], inside.shape)
        TY = np.broadcast_to(ty[:, None], inside.shape)
        patch = _texels(tex_flat, i, TX, TY)
        region = img[cv0:cv1, cu0:cu1]
        img[cv0:cv1, cu0:cu1] = np.where(inside, patch, region)
    return img
