"""Synthetic stereo(-inertial) sequences for the port's end-to-end runs
(numpy only; port of the stereo part of orb_slam3_vio_fixes_tpu/io/
synthetic.py: make_world, render, orbit_trajectory, make_stereo_sequence,
make_stereo_inertial_sequence).

A cloud of textured square sprites is rendered along a smooth trajectory by
a pin-hole stereo pair with a known baseline; ATE against the generator's
trajectory is the metric the reference's evaluation harness computes. The
only difference from the reference generator is `so3_exp`, evaluated here in
numpy float32 instead of through the JAX package (values agree to float32
rounding).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

TEX = 12  # per-sprite texture resolution


def so3_exp(w) -> np.ndarray:
    """Rodrigues' formula in float32: (3,) -> (3, 3)."""
    w = np.asarray(w, np.float32)
    th2 = np.float32(w @ w)
    W = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]],
                 np.float32)
    if th2 < 1e-8:
        a = np.float32(1.0) - th2 / np.float32(6.0)
        b = np.float32(0.5) - th2 / np.float32(24.0)
    else:
        th = np.sqrt(th2, dtype=np.float32)
        a = np.sin(th) / th
        b = (np.float32(1.0) - np.cos(th)) / th2
    return (np.eye(3, dtype=np.float32) + a * W + b * (W @ W)).astype(np.float32)


class SyntheticWorld(NamedTuple):
    points: np.ndarray       # (M, 3) sprite centers
    sprite_size: np.ndarray  # (M,) half-size in world units
    sprite_tex: np.ndarray   # (M, TEX, TEX) per-sprite random texture


def make_world(rng, n_points=600, extent=12.0, depth_range=(4.0, 18.0)) -> SyntheticWorld:
    pts = np.stack(
        [
            rng.uniform(-extent, extent, n_points),
            rng.uniform(-extent * 0.6, extent * 0.6, n_points),
            rng.uniform(depth_range[0], depth_range[1], n_points),
        ],
        axis=1,
    ).astype(np.float32)
    # blocky random textures make every sprite's corners descriptively unique
    # (uniform sprites would alias all BRIEF descriptors onto each other)
    tex = rng.uniform(70, 250, size=(n_points, TEX, TEX)).astype(np.float32)
    tex = np.repeat(np.repeat(tex[:, ::2, ::2], 2, axis=1), 2, axis=2)[:, :TEX, :TEX]
    return SyntheticWorld(
        points=pts,
        sprite_size=rng.uniform(0.06, 0.16, n_points).astype(np.float32),
        sprite_tex=tex,
    )


def render(world: SyntheticWorld, K: np.ndarray, R_cw: np.ndarray, t_cw: np.ndarray,
           h: int, w: int, background: float = 60.0,
           return_depth: bool = False, project_fn=None):
    """Render textured square sprites with painter's order (far first).

    Texture lookup is bilinear at float coordinates anchored to the sprite's
    *float* projection — sub-pixel camera motion shifts pixel intensities
    continuously like a real image (an integer-snapped renderer makes
    consecutive frames identical under small motion, which silently teaches
    the tracker that the camera never moves)."""
    img = np.full((h, w), background, np.float32)
    zbuf = np.full((h, w), -1.0, np.float32)
    Xc = world.points @ R_cw.T + t_cw
    z = Xc[:, 2]
    vis = z > 0.3
    order = np.argsort(-z)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    if project_fn is not None:
        # non-pinhole model (e.g. KB8 fisheye): batched projection of all
        # sprite centers; sprite extent keeps the pinhole fx/z approximation
        uv_all = np.asarray(project_fn(Xc), np.float32)
    else:
        zs = np.maximum(z, 1e-6)
        uv_all = np.stack(
            [fx * Xc[:, 0] / zs + cx, fy * Xc[:, 1] / zs + cy], axis=1)
    for i in order:
        if not vis[i]:
            continue
        u, v = uv_all[i]
        half = world.sprite_size[i] * fx / z[i]
        if half < 2.0:
            half = 2.0
        u0f, v0f = u - half, v - half
        size = 2.0 * half
        cu0, cu1 = max(int(np.floor(u0f)), 0), min(int(np.ceil(u + half)) + 1, w)
        cv0, cv1 = max(int(np.floor(v0f)), 0), min(int(np.ceil(v + half)) + 1, h)
        if cu1 <= cu0 or cv1 <= cv0:
            continue
        uu = np.arange(cu0, cu1, dtype=np.float32)
        vv = np.arange(cv0, cv1, dtype=np.float32)
        tx = (uu - u0f) / size * (TEX - 1)
        ty = (vv - v0f) / size * (TEX - 1)
        inside_x = (tx >= 0) & (tx <= TEX - 1)
        inside_y = (ty >= 0) & (ty <= TEX - 1)
        txc = np.clip(tx, 0, TEX - 1 - 1e-4)
        tyc = np.clip(ty, 0, TEX - 1 - 1e-4)
        x0 = txc.astype(int)
        y0 = tyc.astype(int)
        ax = (txc - x0)[None, :]
        ay = (tyc - y0)[:, None]
        t = world.sprite_tex[i]
        patch = (
            t[np.ix_(y0, x0)] * (1 - ay) * (1 - ax)
            + t[np.ix_(y0, x0 + 1)] * (1 - ay) * ax
            + t[np.ix_(y0 + 1, x0)] * ay * (1 - ax)
            + t[np.ix_(y0 + 1, x0 + 1)] * ay * ax
        )
        mask = inside_y[:, None] & inside_x[None, :]
        region = img[cv0:cv1, cu0:cu1]
        img[cv0:cv1, cu0:cu1] = np.where(mask, patch, region)
        zregion = zbuf[cv0:cv1, cu0:cu1]
        zbuf[cv0:cv1, cu0:cu1] = np.where(mask, np.float32(z[i]), zregion)
    if return_depth:
        return img, zbuf
    return img

class StereoSequence(NamedTuple):
    imgs_l: np.ndarray   # (T, H, W)
    imgs_r: np.ndarray
    ts: np.ndarray       # (T,)
    R_wc: np.ndarray     # (T, 3, 3) ground truth camera-to-world
    t_wc: np.ndarray     # (T, 3) camera centers
    K: np.ndarray
    baseline: float


def orbit_trajectory(n_frames, dt=0.05, radius=0.0, speed=(0.25, 0.0, 0.0),
                     yaw_rate=0.0):
    """Simple smooth trajectory: constant velocity + optional yaw."""
    R_wc = np.zeros((n_frames, 3, 3))
    t_wc = np.zeros((n_frames, 3))
    for i in range(n_frames):
        yaw = yaw_rate * i * dt
        R_wc[i] = so3_exp([0.0, yaw, 0.0])
        t_wc[i] = np.asarray(speed) * (i * dt)
    return R_wc, t_wc


def make_stereo_sequence(
    rng, n_frames=40, h=320, w=480, fx=350.0, baseline=0.11, dt=0.05,
    speed=(0.8, 0.0, 0.12), yaw_rate=0.06, world=None,
) -> StereoSequence:
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]], np.float32)
    if world is None:
        world = make_world(rng)
    R_wc, t_wc = orbit_trajectory(n_frames, dt, speed=speed, yaw_rate=yaw_rate)
    imgs_l = np.zeros((n_frames, h, w), np.float32)
    imgs_r = np.zeros((n_frames, h, w), np.float32)
    b_off = np.array([baseline, 0.0, 0.0], np.float32)
    for i in range(n_frames):
        R_cw = R_wc[i].T
        t_cw = -R_cw @ t_wc[i]
        imgs_l[i] = render(world, K, R_cw, t_cw, h, w)
        # right camera center = C + R_wc @ [b,0,0]
        C_r = t_wc[i] + R_wc[i] @ b_off
        t_cw_r = -R_cw @ C_r
        imgs_r[i] = render(world, K, R_cw, t_cw_r, h, w)
    ts = np.arange(n_frames) * dt
    return StereoSequence(imgs_l, imgs_r, ts, R_wc, t_wc, K, baseline)


class StereoInertialSequence(NamedTuple):
    imgs_l: np.ndarray
    imgs_r: np.ndarray
    ts: np.ndarray
    R_wc: np.ndarray
    t_wc: np.ndarray
    K: np.ndarray
    baseline: float
    imu: np.ndarray        # (T-1, S, 7) [acc(3), gyro(3), dt] between frames
    imu_hz: float
    vel_gt: np.ndarray     # (T, 3) world-frame velocity


def make_stereo_inertial_sequence(
    rng, n_frames=40, h=240, w=352, fx=260.0, baseline=0.2, dt=0.05,
    imu_hz=200.0, world=None, accel_amp=0.6, yaw_rate=0.1,
    gyro_noise=0.0, acc_noise=0.0,
) -> StereoInertialSequence:
    """Stereo frames and exact IMU samples between them: sinusoidal world
    acceleration with a constant yaw rate, gravity (0, 0, -9.81), body frame
    = camera frame. Accelerometer a_b = R_wb^T (a_w - g), gyro
    w_b = R_wb^T w_w. Draws from `rng` in the reference generator's order."""
    G = np.array([0.0, 0.0, -9.81], np.float32)
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]], np.float32)
    if world is None:
        world = make_world(rng)
    spf = int(round(dt * imu_hz))
    dts = 1.0 / imu_hz
    n_samp = spf * (n_frames - 1)
    tt = np.arange(n_samp) * dts
    a_w = np.stack([
        accel_amp * np.sin(1.7 * tt),
        0.4 * accel_amp * np.cos(1.3 * tt),
        0.5 * accel_amp * np.sin(2.1 * tt),
    ], 1).astype(np.float32)
    w_w = np.tile(np.array([0.0, yaw_rate, 0.0], np.float32), (n_samp, 1))

    R = np.eye(3, dtype=np.float32)
    p = np.zeros(3, np.float32)
    v = np.array([0.5, 0.0, 0.1], np.float32)
    R_wc = np.zeros((n_frames, 3, 3), np.float32)
    t_wc = np.zeros((n_frames, 3), np.float32)
    vel = np.zeros((n_frames, 3), np.float32)
    R_wc[0], t_wc[0], vel[0] = R, p, v
    imu = np.zeros((n_frames - 1, spf, 7), np.float32)
    fidx = 0
    for k in range(n_samp):
        a_b = R.T @ (a_w[k] - G) + rng.normal(0, acc_noise, 3)
        w_b = R.T @ w_w[k] + rng.normal(0, gyro_noise, 3)
        imu[fidx, k - fidx * spf] = np.concatenate([a_b, w_b, [dts]])
        p = p + v * dts + 0.5 * a_w[k] * dts * dts
        v = v + a_w[k] * dts
        R = R @ so3_exp(R.T @ w_w[k] * dts)
        if (k + 1) % spf == 0:
            fidx += 1
            R_wc[fidx], t_wc[fidx], vel[fidx] = R, p, v

    imgs_l = np.zeros((n_frames, h, w), np.float32)
    imgs_r = np.zeros((n_frames, h, w), np.float32)
    b_off = np.array([baseline, 0.0, 0.0], np.float32)
    for i in range(n_frames):
        R_cw = R_wc[i].T
        imgs_l[i] = render(world, K, R_cw, -R_cw @ t_wc[i], h, w)
        C_r = t_wc[i] + R_wc[i] @ b_off
        imgs_r[i] = render(world, K, R_cw, -R_cw @ C_r, h, w)
    ts = np.arange(n_frames) * dt
    return StereoInertialSequence(
        imgs_l, imgs_r, ts, R_wc, t_wc, K, baseline, imu, imu_hz, vel)
