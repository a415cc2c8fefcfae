"""Camera models: pin-hole and Kannala-Brandt8 fisheye (port of
orb_slam3_vio_fixes_tpu/utils/cameras.py).

A camera is a NamedTuple of Python floats rounded to float32, the precision
the reference's jnp scalars carry; a float32 tensor times one of these
computes with the same scalar. KB8 is the fisheye rig's model (the
two-camera frame build and the monocular residuals of its frames).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

PINHOLE = 0
KB8 = 1


def f32(x) -> float:
    """Round to float32 precision, kept as a Python float."""
    return float(np.float32(x))


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    dist: tuple = (0.0, 0.0, 0.0, 0.0)
    kind: int = PINHOLE

    @staticmethod
    def pinhole(fx, fy, cx, cy) -> "Camera":
        return Camera(f32(fx), f32(fy), f32(cx), f32(cy),
                      (0.0, 0.0, 0.0, 0.0), PINHOLE)

    @staticmethod
    def kb8(fx, fy, cx, cy, k1, k2, k3, k4) -> "Camera":
        return Camera(f32(fx), f32(fy), f32(cx), f32(cy),
                      tuple(f32(k) for k in (k1, k2, k3, k4)), KB8)



@functools.lru_cache(maxsize=None)
def k_inv(cam: Camera, device) -> torch.Tensor:
    """Closed-form inverse of K, cached per device (read-only)."""
    return torch.tensor(
        [[1.0 / cam.fx, 0.0, -cam.cx / cam.fx],
         [0.0, 1.0 / cam.fy, -cam.cy / cam.fy], [0.0, 0.0, 1.0]],
        dtype=torch.float32, device=device)


def _kb8_theta_d(theta, dist):
    t2 = theta * theta
    return theta * (1.0 + t2 * (dist[0] + t2 * (dist[1] + t2 * (
        dist[2] + t2 * dist[3]))))


def _safe_inv(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)


def project(cam: Camera, pc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixels (..., 2)."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    if cam.kind == PINHOLE:
        inv_z = _safe_inv(z)
        return torch.stack([cam.fx * x * inv_z + cam.cx,
                            cam.fy * y * inv_z + cam.cy], dim=-1)
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(r, z)
    scale = _kb8_theta_d(theta, cam.dist) / torch.clamp(r, min=1e-9)
    on_axis = r < 1e-9
    u = torch.where(on_axis, torch.full_like(x, cam.cx),
                    cam.fx * x * scale + cam.cx)
    v = torch.where(on_axis, torch.full_like(y, cam.cy),
                    cam.fy * y * scale + cam.cy)
    return torch.stack([u, v], dim=-1)


def unproject(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> bearing (..., 3) with z = 1."""
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    if cam.kind == PINHOLE:
        return torch.stack([mx, my, torch.ones_like(mx)], dim=-1)
    d = torch.clamp(torch.sqrt(mx * mx + my * my), max=np.pi)
    theta = d
    k = cam.dist
    for _ in range(10):
        t2 = theta * theta
        f = theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3])))) - d
        df = 1.0 + t2 * (3 * k[0] + t2 * (5 * k[1] + t2 * (7 * k[2] + t2 * 9 * k[3])))
        theta = theta - f / torch.clamp(df.abs(), min=1e-9) * torch.sign(df)
    scale = torch.where(d > 1e-8, torch.tan(theta) / torch.clamp(d, min=1e-8),
                        torch.ones_like(d))
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def project_jac(cam: Camera, pc: torch.Tensor) -> torch.Tensor:
    """d(project)/d(pc): (..., 2, 3). Closed form for pin-hole, forward-mode
    autodiff for KB8 (as the reference)."""
    if cam.kind == PINHOLE:
        x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
        inv_z = _safe_inv(z)
        inv_z2 = inv_z * inv_z
        zeros = torch.zeros_like(x)
        row_u = torch.stack([cam.fx * inv_z, zeros, -cam.fx * x * inv_z2], -1)
        row_v = torch.stack([zeros, cam.fy * inv_z, -cam.fy * y * inv_z2], -1)
        return torch.stack([row_u, row_v], dim=-2)
    flat = pc.reshape(-1, 3)
    # each point as a (1, 3) batch: the scalars of a (3,) point would be
    # 0-dim tensors, which forward-mode AD promotes to float64 against a
    # Python float
    jac = torch.func.vmap(torch.func.jacfwd(lambda p: project(cam, p[None])[0]))(flat)
    return jac.reshape(pc.shape[:-1] + (2, 3))


def stereo_project(cam: Camera, bf: float, pc: torch.Tensor) -> torch.Tensor:
    """(u_l, v_l, u_r) with u_r = u_l - bf / z."""
    uv = project(cam, pc)
    ur = uv[..., 0] - bf * _safe_inv(pc[..., 2])
    return torch.cat([uv, ur[..., None]], dim=-1)


def in_image(uv: torch.Tensor, width: int, height: int,
             margin: float = 0.0) -> torch.Tensor:
    return ((uv[..., 0] >= margin) & (uv[..., 0] < width - margin)
            & (uv[..., 1] >= margin) & (uv[..., 1] < height - margin))
