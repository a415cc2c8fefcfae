"""The ideal pin-hole camera: u = fx x / z + cx, v = fy y / z + cy; a
sprite of half-size s metres at depth z spans s fx / z pixels each way."""

import numpy as np

from slam_bench.render import f32


def project(x, y, z, size, cam, xp):
    """(u, v, half-size in pixels) of points (x, y, z) in the camera's frame,
    in float32 on torch tensors or numpy arrays (`xp` is the module)."""
    zs = np.maximum(z, np.float32(1e-6)) if xp is np else z.clamp(min=1e-6)
    fx, fy, cx, cy = f32(cam.fx), f32(cam.fy), f32(cam.cx), f32(cam.cy)
    return fx * x / zs + cx, fy * y / zs + cy, size * fx / z
