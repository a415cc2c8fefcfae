"""The one generator of the benchmark's camera streams.

A traffic file (`slam_bench/traffic/<name>.json`) gives the parameters, and
any path, world and sensor effect is a matter of its numbers:

- `path`: the rig's kinematics. The world acceleration and the world
  angular rate are each a sum of sinusoid terms `[axis, amplitude,
  frequency (rad/s), phase (rad)]` (a constant is a term of frequency 0
  and phase pi / 2), from the start pose `p0` / `rot0` (an axis-angle) and
  velocity `v0`, under gravity (0, 0, -9.81). A flight, a drive or a circle
  of laps is a choice of terms. The IMU samples follow from the same
  integration for every path.
- `world`: groups of square textured sprites, each laid along random pixel
  rays (`ray_x`, `ray_y`: tangent ranges, `depth`: metres along the ray) of
  every `every`-th pose up to `until_frame` (default: every pose), so that a
  path that returns to where a group was laid sees it again.
- `noise_sigma`: grey levels of image noise; `blackout`: frame ranges
  `[first, last)` whose images show nothing (a covered lens).

The configuration gives the camera (its projection model, by name, is a
module `slam_bench/cameras/<model>.py`), the right camera (default: the
left one moved `baseline` along its x axis) and the IMU's noise densities.
The seed draws the world, the image noise and the IMU noise; every seed
gets the same number of frames, sprites and IMU samples.

The sprites and images are made on the given device (a `torch.Generator`
there, a few large draws) by `render.render_many`; the frames are then held
on the host as uint8 pairs, as a camera delivers them. The ground truth is
the generator's own: camera-to-world poses (the body frame is the left
camera), world velocities, the IMU's biases and, where the configuration
has an IMU, its samples between frames.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from slam_bench import render

G_WORLD = np.array([0.0, 0.0, -9.81])
CHUNK = 16                  # poses rendered per call
QUIET_IMU = {"rate_hz": 200.0, "noise_gyro": 0.0, "noise_acc": 0.0, "walk_gyro": 0.0,
             "walk_acc": 0.0}


class Scene(NamedTuple):
    imgs: np.ndarray             # (N, 2, H, W) uint8 left / right
    ts: np.ndarray               # (N,) float64 seconds
    R_wc: np.ndarray             # (N, 3, 3) float64 camera to world
    t_wc: np.ndarray             # (N, 3) float64 camera centres
    v_w: np.ndarray              # (N, 3) float64 world velocities
    bias: np.ndarray             # (N, 6) float64 IMU biases [acc, gyro] from frame i on
    imu: Optional[list]          # N arrays (n_i, 7) float32 [acc, gyro, dt] or None


def n_frames(traffic: dict, seconds: float, max_fps: float) -> int:
    """Frames a run needs: the longest warm-up and `seconds` at `max_fps`."""
    return int(traffic["warmup"]["max_frames"]) + int(math.ceil(seconds * max_fps))


def so3_exp(w) -> np.ndarray:
    w = np.asarray(w, np.float64)
    th = float(np.linalg.norm(w))
    W = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if th < 1e-9:
        return np.eye(3) + W + 0.5 * W @ W
    return np.eye(3) + math.sin(th) / th * W + (1 - math.cos(th)) / th**2 * W @ W


def sinusoids(terms, tt) -> np.ndarray:
    """(len(tt), 3): the sum of `[axis, amplitude, frequency, phase]` terms."""
    out = np.zeros((len(tt), 3))
    for axis, amp, freq, phase in terms:
        out[:, int(axis)] += amp * np.sin(freq * tt + phase)
    return out


def path(p: dict, n: int, imu: dict, rng):
    """Integrates the path's kinematics per IMU sample over n frames: (R_wc,
    t_wc, v_w, bias, IMU samples per frame). The IMU reads specific force
    and body rate plus white noise and a random-walk bias at the densities
    of `imu` (continuous-time, per sqrt(Hz))."""
    dt = 1.0 / p["fps"]
    spf = int(round(dt * imu["rate_hz"]))
    dts = 1.0 / imu["rate_hz"]
    n_samp = spf * (n - 1)
    # each sample holds over its interval the value at the interval's middle
    tt = (np.arange(n_samp) + 0.5) * dts
    a_w = sinusoids(p.get("accel", ()), tt)
    w_w = sinusoids(p.get("rate", ()), tt)
    sq = math.sqrt(imu["rate_hz"])
    white = rng.standard_normal((n_samp, 6)) * np.repeat(
        [imu["noise_acc"] * sq, imu["noise_gyro"] * sq], 3)
    walk = np.cumsum(rng.standard_normal((n_samp, 6)) * np.repeat(
        [imu["walk_acc"] / sq, imu["walk_gyro"] / sq], 3), axis=0)
    R = so3_exp(p.get("rot0", (0.0, 0.0, 0.0)))
    pos = np.asarray(p.get("p0", (0.0, 0.0, 0.0)), np.float64)
    v = np.asarray(p["v0"], np.float64)
    R_wc, t_wc, v_w = np.zeros((n, 3, 3)), np.zeros((n, 3)), np.zeros((n, 3))
    R_wc[0], t_wc[0], v_w[0] = R, pos, v
    samples = np.zeros((n_samp, 7), np.float32)
    for k in range(n_samp):
        a_b = R.T @ (a_w[k] - G_WORLD)
        w_b = R.T @ w_w[k]
        samples[k, :3] = a_b + white[k, :3] + walk[k, :3]
        samples[k, 3:6] = w_b + white[k, 3:] + walk[k, 3:]
        samples[k, 6] = dts
        pos = pos + v * dts + 0.5 * a_w[k] * dts * dts
        v = v + a_w[k] * dts
        R = R @ so3_exp(w_b * dts)
        if (k + 1) % spf == 0:
            i = (k + 1) // spf
            R_wc[i], t_wc[i], v_w[i] = R, pos, v
    # the bias in force on the samples that follow each frame
    bias = (walk[np.minimum(np.arange(n) * spf, n_samp - 1)] if n_samp
            else np.zeros((n, 6)))
    imu_frames = [np.zeros((0, 7), np.float32)] + [
        samples[i * spf:(i + 1) * spf] for i in range(n - 1)]
    return R_wc, t_wc, v_w, bias, imu_frames


def _uniform(shape, lo, hi, gen, device):
    return torch.empty(shape, device=device).uniform_(lo, hi, generator=gen)


def _textures(m: int, gen, device) -> torch.Tensor:
    """Blocky random textures: 6 x 6 draws, each covering 2 x 2 texels."""
    t = _uniform((m, 6, 6), 70.0, 250.0, gen, device)
    return t.repeat_interleave(2, 1).repeat_interleave(2, 2)


def world_group(wp: dict, R_wc, t_wc, gen, device) -> render.World:
    """`per_anchor` sprites along random pixel rays of every `every`-th pose
    (up to `until_frame`) at uniform depths."""
    anchors = np.arange(0, min(len(R_wc), wp.get("until_frame", len(R_wc))), wp["every"])
    per = wp["per_anchor"]
    m = len(anchors) * per
    dx = _uniform((m,), -wp["ray_x"], wp["ray_x"], gen, device)
    dy = _uniform((m,), -wp["ray_y"], wp["ray_y"], gen, device)
    d = _uniform((m,), *wp["depth"], gen, device)
    rays = torch.stack([dx, dy, torch.ones_like(dx)], 1)
    rays = rays / torch.linalg.norm(rays, dim=1, keepdim=True) * d[:, None]
    R = torch.as_tensor(R_wc[anchors], dtype=torch.float32, device=device)
    t = torch.as_tensor(t_wc[anchors], dtype=torch.float32, device=device)
    R = R.repeat_interleave(per, 0)
    t = t.repeat_interleave(per, 0)
    pts = t + (R @ rays[:, :, None])[:, :, 0]
    return render.World(pts, _uniform((m,), *wp["size"], gen, device), _textures(m, gen, device))


def world(groups, R_wc, t_wc, gen, device) -> render.World:
    parts = [world_group(g, R_wc, t_wc, gen, device) for g in groups]
    return render.World(*(torch.cat(x) for x in zip(*parts)))


def cameras(c: dict):
    """(left camera, right camera, R_lr, t_lr): the right camera's pose in
    the left camera's frame."""
    left = render.camera(c)
    right = render.camera({**c, **c.get("right", {})})
    T = c.get("T_c1_c2", {"R": np.eye(3).tolist(), "t": [c["baseline"], 0.0, 0.0]})
    return left, right, np.asarray(T["R"], np.float64), np.asarray(T["t"], np.float64)


def _render_pairs(wld, rig, R_wc, t_wc) -> torch.Tensor:
    """(K, 2, H, W) float32 left / right images at K poses."""
    left, right, R_lr, t_lr = rig
    out = []
    for cam, R, t in ((left, R_wc, t_wc), (right, R_wc @ R_lr, t_wc + R_wc @ t_lr)):
        R_cw = np.transpose(R, (0, 2, 1))
        out.append(render.render_many(wld, cam, R_cw, -(R_cw @ t[..., None])[..., 0]))
    return torch.stack(out, 1)


def make(traffic: dict, config: dict, seed: int, seconds: float, max_fps: float,
         device) -> Scene:
    """The scene of one run: `n_frames(traffic, seconds, max_fps)` frames.
    A configuration without an IMU gets the same path and no IMU samples."""
    n = n_frames(traffic, seconds, max_fps)
    c = config["camera"]
    rig = cameras(c)
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    p = traffic["path"]
    if p["fps"] != c["fps"]:
        raise ValueError(f"traffic at {p['fps']} fps against a {c['fps']} fps camera")
    R_wc, t_wc, v_w, bias, imu = path(p, n, config.get("imu", QUIET_IMU), rng)
    if "imu" not in config:
        imu = None
    wld = world(traffic["world"], R_wc, t_wc, gen, device)
    dark = np.zeros(n, bool)
    for a, b in traffic.get("blackout", ()):
        dark[a:b] = True
    imgs = np.empty((n, 2, c["height"], c["width"]), np.uint8)
    for i0 in range(0, n, CHUNK):
        i1 = min(i0 + CHUNK, n)
        batch = _render_pairs(wld, rig, R_wc[i0:i1], t_wc[i0:i1])
        batch[torch.as_tensor(dark[i0:i1], device=batch.device)] = 0.0
        noisy = batch + traffic["noise_sigma"] * torch.randn(batch.shape, device=batch.device,
                                                             generator=gen)
        imgs[i0:i1] = torch.round(noisy).clamp(0, 255).to(torch.uint8).cpu().numpy()
    ts = np.arange(n) / p["fps"]
    return Scene(imgs, ts, R_wc, t_wc, v_w, bias, imu)
