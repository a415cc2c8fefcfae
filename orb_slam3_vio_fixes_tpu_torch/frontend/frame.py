"""Stereo, two-camera fisheye, RGB-D and monocular frame construction (port
of orb_slam3_vio_fixes_tpu/frontend/frame.py: FrameData, sad_subpixel,
build_stereo_frame_impl, build_fisheye_stereo_frame, build_rgbd_frame,
build_mono_frame)."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from orb_slam3_vio_fixes_tpu_torch.ops import image as image_ops
from orb_slam3_vio_fixes_tpu_torch.ops import matching, orb
from orb_slam3_vio_fixes_tpu_torch.ops import triangulate as tri
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera, project, unproject


class FrameData(NamedTuple):
    """Per-frame fixed-capacity feature arrays (N = n_features)."""

    uv: torch.Tensor      # (N, 2) level-0 pixel coords (left cam)
    ur: torch.Tensor      # (N,) right-cam u (-1 mono / unmatched)
    depth: torch.Tensor   # (N,) stereo depth (-1 unknown)
    octave: torch.Tensor  # (N,) int32
    angle: torch.Tensor   # (N,) float32
    desc: torch.Tensor    # (N, 8) int32 bit patterns
    valid: torch.Tensor   # (N,) bool
    ts: torch.Tensor      # () float32 timestamp


def to_f32(img: torch.Tensor) -> torch.Tensor:
    """uint8 camera gray or uint16 fixed point (value * 256) -> float32."""
    x = img.to(torch.float32)
    if img.dtype == torch.uint16:
        x = x * (1.0 / 256.0)
    return x


SAD_W = 5
SAD_SLIDE = 5


def _windows(img: torch.Tensor, pad: int, y0: torch.Tensor, x0: torch.Tensor,
             height: int, width: int) -> torch.Tensor:
    """(N, height, width) windows of the edge-padded img with top-left corner
    (y0, x0) in padded coordinates, start clamped into range like
    jax.lax.dynamic_slice."""
    padded = F.pad(img[None, None], (pad,) * 4, mode="replicate")[0, 0]
    Hp, Wp = padded.shape
    y0 = y0.clamp(0, Hp - height)
    x0 = x0.clamp(0, Wp - width)
    yy = y0[:, None, None] + torch.arange(height, device=img.device)[None, :, None]
    xx = x0[:, None, None] + torch.arange(width, device=img.device)[None, None, :]
    return padded.reshape(-1)[yy * Wp + xx]


def sad_subpixel(img_l, img_r, uv_l, ur0, valid):
    """Sub-pixel disparity by sliding 11x11 SAD over +-5 px and a parabola
    fit, then the SAD-median outlier sweep. Returns refined ur (-1 invalid)."""
    pad = SAD_W + SAD_SLIDE + 1
    ui = torch.round(uv_l[:, 0]).to(torch.int64)
    vi = torch.round(uv_l[:, 1]).to(torch.int64)
    uri = torch.round(ur0).to(torch.int64)
    patch_l = _windows(img_l, pad, vi + pad - SAD_W, ui + pad - SAD_W,
                       2 * SAD_W + 1, 2 * SAD_W + 1)
    strip_r = _windows(img_r, pad, vi + pad - SAD_W,
                       uri - SAD_SLIDE + pad - SAD_W, 2 * SAD_W + 1,
                       2 * (SAD_W + SAD_SLIDE) + 1)
    cl = patch_l[:, SAD_W, SAD_W][:, None, None]
    sads = []
    for off in range(2 * SAD_SLIDE + 1):
        win = strip_r[:, :, off:off + 2 * SAD_W + 1]
        cr = win[:, SAD_W, SAD_W][:, None, None]
        sads.append(((patch_l - cl) - (win - cr)).abs().sum(dim=(1, 2)))
    sad = torch.stack(sads, dim=1)
    best = torch.argmin(sad, dim=1)
    interior = (best > 0) & (best < 2 * SAD_SLIDE)
    bi = best.clamp(1, 2 * SAD_SLIDE - 1)
    s0 = torch.gather(sad, 1, bi[:, None])[:, 0]
    sm = torch.gather(sad, 1, (bi - 1)[:, None])[:, 0]
    sp = torch.gather(sad, 1, (bi + 1)[:, None])[:, 0]
    denom = sm + sp - 2.0 * s0
    delta = torch.where(denom.abs() > 1e-6, (sm - sp) / (2.0 * denom),
                        torch.zeros_like(denom))
    ok = valid & interior & (delta.abs() <= 1.0)
    ur_ref = uri.to(torch.float32) + (bi.to(torch.float32) - SAD_SLIDE) + delta
    med = matching.nanmedian(torch.where(ok, s0, torch.full_like(s0, float("nan"))))
    med = torch.nan_to_num(med, nan=1e9)
    ok &= s0 <= 2.1 * med
    # apply the integer-anchored displacement to the float keypoint x (see
    # the reference on the fractional-x bias this avoids)
    disp_int = ui.to(torch.float32) - ur_ref
    ur_out = uv_l[:, 0] - disp_int
    return torch.where(ok, ur_out, torch.full_like(ur_out, -1.0))


def build_stereo_frame_impl(img_l: torch.Tensor, img_r: torch.Tensor,
                            ts: torch.Tensor, cam: Camera, bf: float,
                            cfg: orb.ORBConfig) -> FrameData:
    """ORB on both eyes (one batched extraction) + row-banded stereo match +
    SAD sub-pixel refinement. Disparity bounds: [0, bf / baseline = fx]."""
    img_l = to_f32(img_l)
    img_r = to_f32(img_r)
    fl, fr = orb.extract_pair(img_l, img_r, cfg)
    sf = image_ops.scale_factors(cfg.n_levels, cfg.scale, device=img_l.device)
    baseline = bf / cam.fx
    max_disp = bf / baseline
    ur, disp, _ = matching.stereo_row_match(
        fl.uv, fl.valid, fl.desc, fl.octave, fr.uv, fr.valid, fr.desc,
        fr.octave, sf, 0.0, max_disp)
    ur = sad_subpixel(img_l, img_r, fl.uv, ur, (disp > 0) & fl.valid)
    disp = torch.where(ur >= 0, fl.uv[:, 0] - ur, torch.full_like(ur, -1.0))
    disp = torch.where((ur >= 0) & (disp < 0.01), torch.full_like(disp, 0.01), disp)
    depth = torch.where(disp > 0, bf / torch.clamp(disp, min=1e-6),
                        torch.full_like(disp, -1.0))
    return FrameData(uv=fl.uv, ur=torch.where(disp > 0, ur, torch.full_like(ur, -1.0)),
                     depth=depth, octave=fl.octave, angle=fl.angle,
                     desc=fl.desc, valid=fl.valid, ts=ts)


def build_fisheye_stereo_frame(img_l: torch.Tensor, img_r: torch.Tensor,
                               ts: torch.Tensor, cam1: Camera, cam2: Camera,
                               R_12: torch.Tensor, t_12: torch.Tensor,
                               cfg: orb.ORBConfig) -> FrameData:
    """Two-camera (KannalaBrandt8) stereo: ORB on both eyes (one B = 2 atlas
    through K1), brute-force mutual matching with ratio 0.7 (K2 over every
    valid pair), then midpoint triangulation of the two unprojected rays.
    A match keeps its depth when the rays' parallax cosine is below 0.9998,
    the point lies in front of both cameras and both reprojection errors
    pass the per-octave chi2 gate (5.991). T_c1_c2 = (R_12, t_12) maps
    camera-2 coordinates into camera 1's. `depth` holds the left camera's z;
    `ur` stays -1, so pose optimisation uses monocular residuals."""
    img_l = to_f32(img_l)
    img_r = to_f32(img_r)
    fl, fr = orb.extract_pair(img_l, img_r, cfg)
    m = matching.match_descriptors(fl.desc, fl.valid, fr.desc, fr.valid, ratio=0.7,
                                   max_dist=matching.TH_HIGH, mutual=True)
    n = fl.uv.shape[0]
    ridx = m.idx.to(torch.int64).clamp(0, fr.uv.shape[0] - 1)
    uv2 = fr.uv[ridx]
    oct2 = fr.octave[ridx]
    ray1 = unproject(cam1, fl.uv)
    ray2 = unproject(cam2, uv2)
    R_21 = R_12.T
    t_21 = -R_12.T @ t_12
    eye = torch.eye(3, device=ray1.device).expand(n, 3, 3)
    Xc1 = tri.triangulate_midpoint(eye, torch.zeros_like(ray1), R_21.expand(n, 3, 3),
                                   t_21.expand(n, 3), ray1, ray2)
    Xc2 = Xc1 @ R_21.T + t_21
    r1n = ray1 / torch.linalg.norm(ray1, dim=-1, keepdim=True)
    r2w = ray2 @ R_12.T                 # the right ray in camera 1's frame
    r2n = r2w / torch.linalg.norm(r2w, dim=-1, keepdim=True)
    cos_par = (r1n * r2n).sum(-1)
    sf = image_ops.scale_factors(cfg.n_levels, cfg.scale, device=ray1.device)
    sigma2 = sf * sf
    s21 = sigma2[fl.octave.to(torch.int64).clamp(0, cfg.n_levels - 1)]
    s22 = sigma2[oct2.to(torch.int64).clamp(0, cfg.n_levels - 1)]
    e1 = project(cam1, Xc1) - fl.uv
    e2 = project(cam2, Xc2) - uv2
    ok = ((m.idx >= 0) & fl.valid & (Xc1[:, 2] > 0.01) & (Xc2[:, 2] > 0.01)
          & (cos_par < 0.9998) & ((e1 * e1).sum(-1) / s21 < 5.991)
          & ((e2 * e2).sum(-1) / s22 < 5.991))
    neg = torch.full((n,), -1.0, device=ray1.device)
    return FrameData(uv=fl.uv, ur=neg, depth=torch.where(ok, Xc1[:, 2], neg),
                     octave=fl.octave, angle=fl.angle, desc=fl.desc, valid=fl.valid, ts=ts)


def _extract_one(img: torch.Tensor, cfg: orb.ORBConfig) -> orb.Features:
    """ORB on one image: a B = 1 atlas through K1."""
    return orb.extract(to_f32(img), cfg)


def build_mono_frame(img: torch.Tensor, ts: torch.Tensor, cfg: orb.ORBConfig) -> FrameData:
    """Monocular: ORB on the one image; no right coordinate, no depth."""
    f = _extract_one(img, cfg)
    neg = torch.full_like(f.angle, -1.0)
    return FrameData(uv=f.uv, ur=neg, depth=neg.clone(), octave=f.octave, angle=f.angle,
                     desc=f.desc, valid=f.valid, ts=ts)


def build_rgbd_frame(img: torch.Tensor, depth_img: torch.Tensor, ts: torch.Tensor,
                     cam: Camera, bf: float, cfg: orb.ORBConfig) -> FrameData:
    """RGB-D: ORB on the one image (a B = 1 atlas through K1), the depth map
    sampled at each keypoint (coordinates truncated to int and clipped) and
    a synthetic right coordinate ur = u - bf / z where z > 0. `depth_img`
    is metric float32, never quantised."""
    f = _extract_one(img, cfg)
    H, W = depth_img.shape
    xi = f.uv[:, 0].to(torch.int32).clamp(0, W - 1).to(torch.int64)
    yi = f.uv[:, 1].to(torch.int32).clamp(0, H - 1).to(torch.int64)
    z = depth_img.reshape(-1)[yi * W + xi]
    has_d = z > 0
    neg = torch.full_like(z, -1.0)
    ur = torch.where(has_d, f.uv[:, 0] - bf / torch.clamp(z, min=1e-6), neg)
    return FrameData(uv=f.uv, ur=ur, depth=torch.where(has_d, z, neg), octave=f.octave,
                     angle=f.angle, desc=f.desc, valid=f.valid, ts=ts)
