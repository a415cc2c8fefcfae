"""Synthetic stereo(-inertial) sequences for the port's end-to-end runs
(numpy only; port of the stereo part of orb_slam3_vio_fixes_tpu/io/
synthetic.py: make_world, render, orbit_trajectory, make_stereo_sequence,
make_stereo_inertial_sequence, the loop scenario's render_stereo_along,
loop_trajectory, make_loop_world, make_loop_stereo_sequence,
make_loop_stereo_inertial_sequence, make_rgbd_sequence, the sensor-noise
model SensorNoise / degrade_images / degrade_stereo / perturb_imu, and the
ground-truth-trajectory generators load_gt_trajectory,
make_world_along_trajectory, make_gt_stereo_sequence and
make_gt_stereo_inertial_sequence).

A cloud of textured square sprites is rendered along a smooth trajectory by
a pin-hole stereo pair with a known baseline; ATE against the generator's
trajectory is the metric the reference's evaluation harness computes. The
only difference from the reference generator is `so3_exp` / `so3_log`,
evaluated here in numpy float32 instead of through the JAX package (values
agree to float32 rounding). The noise model draws from `rng` in the
reference's order, so one seed gives the same bytes.
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


def so3_log(R) -> np.ndarray:
    """Log map in float32, (3, 3) -> (3,), with the reference's branches: the
    arccos argument clipped 1e-7 inside (-1, 1), a Taylor scale below 1e-5
    rad and the axis from the symmetric part within 5e-4 rad of pi."""
    R = np.asarray(R, np.float32)
    one, half = np.float32(1.0), np.float32(0.5)
    cos_t = np.clip((R[0, 0] + R[1, 1] + R[2, 2] - one) * half,
                    np.float32(-1.0 + 1e-7), np.float32(1.0 - 1e-7))
    th = np.arccos(cos_t, dtype=np.float32)
    A = R - R.T
    w_small = np.array([A[2, 1], A[0, 2], A[1, 0]], np.float32)
    if th < 1e-5:
        scale = half + th * th / np.float32(12.0)
    else:
        scale = th / (np.float32(2.0) * max(np.sin(th), np.float32(1e-20)))
    if np.float32(np.pi) - th >= 5e-4:
        return (np.float32(scale) * w_small).astype(np.float32)
    S = half * (R + R.T)
    k = int(np.argmax(np.diag(S)))
    col = (half * (S + np.eye(3, dtype=np.float32)))[:, k]
    axis = col / np.sqrt(max(col[k], np.float32(1e-12)), dtype=np.float32)
    axis = axis / max(np.linalg.norm(axis), np.float32(1e-12))
    sign = np.float32(-1.0) if float(w_small @ axis) < 0.0 else one
    sin_t = half * np.sqrt(w_small @ w_small + np.float32(1e-24), dtype=np.float32)
    th_pi = np.float32(np.pi) - np.arcsin(np.clip(sin_t, 0.0, np.float32(1.0 - 1e-7)))
    return (th_pi * axis * sign).astype(np.float32)


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


def render_stereo_along(world, K, R_wc, t_wc, ts, h, w, baseline) -> StereoSequence:
    """Render a stereo pair at every pose of (R_wc, t_wc)."""
    n_frames = len(R_wc)
    imgs_l = np.zeros((n_frames, h, w), np.float32)
    imgs_r = np.zeros((n_frames, h, w), np.float32)
    b_off = np.array([baseline, 0.0, 0.0], np.float32)
    for i in range(n_frames):
        R_cw = R_wc[i].T
        imgs_l[i] = render(world, K, R_cw, -R_cw @ t_wc[i], h, w)
        C_r = t_wc[i] + R_wc[i] @ b_off
        imgs_r[i] = render(world, K, R_cw, -R_cw @ C_r, h, w)
    return StereoSequence(imgs_l, imgs_r, np.asarray(ts), np.asarray(R_wc),
                          np.asarray(t_wc), K, baseline)


def loop_trajectory(n_frames, dt=0.05, radius=3.0, look="outward", n_loop=None):
    """A circle of `radius` in the XZ plane looking radially outward,
    `n_loop` frames per lap (default n_frames); frames past n_loop drive the
    start of the lap again (the revisit of a loop-closing run)."""
    if n_loop is None:
        n_loop = n_frames
    R_wc = np.zeros((n_frames, 3, 3), np.float32)
    t_wc = np.zeros((n_frames, 3), np.float32)
    for i in range(n_frames):
        a = 2.0 * np.pi * i / (n_loop - 1)
        t_wc[i] = radius * np.array([np.sin(a), 0.0, -np.cos(a)], np.float32)
        R_wc[i] = so3_exp(np.array([0.0, np.pi - a, 0.0], np.float32))
    return R_wc, t_wc


def make_loop_world(rng, n_points=1200, wall_radius=9.0, height=3.0,
                    depth_jitter=2.0) -> SyntheticWorld:
    """Sprites on a cylindrical band around the loop trajectory."""
    a = rng.uniform(0, 2 * np.pi, n_points)
    r = wall_radius + rng.uniform(-depth_jitter, depth_jitter, n_points)
    pts = np.stack([r * np.sin(a), rng.uniform(-height, height, n_points),
                    -r * np.cos(a)], 1).astype(np.float32)
    tex = rng.uniform(70, 250, size=(n_points, TEX, TEX)).astype(np.float32)
    tex = np.repeat(np.repeat(tex[:, ::2, ::2], 2, axis=1), 2, axis=2)[:, :TEX, :TEX]
    return SyntheticWorld(points=pts,
                          sprite_size=rng.uniform(0.08, 0.2, n_points).astype(np.float32),
                          sprite_tex=tex)


def make_loop_stereo_sequence(rng, n_frames=80, h=240, w=352, fx=260.0, baseline=0.2,
                              dt=0.05, radius=3.0, wall_radius=9.0, n_points=1200,
                              n_loop=None) -> StereoSequence:
    """A stereo sequence around the loop world (the loop-closing scenario)."""
    world = make_loop_world(rng, n_points=n_points, wall_radius=wall_radius)
    R_wc, t_wc = loop_trajectory(n_frames, dt, radius=radius, n_loop=n_loop)
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]], np.float32)
    return render_stereo_along(world, K, R_wc, t_wc, np.arange(n_frames) * dt, h, w,
                               baseline)


def make_loop_stereo_inertial_sequence(
        rng, n_frames=88, n_loop=72, h=240, w=352, fx=260.0, baseline=0.2, dt=0.05,
        imu_hz=200.0, wall_radius=9.0, radius=3.0, n_points=1400, gyro_noise=0.0,
        acc_noise=0.0) -> StereoInertialSequence:
    """The loop scenario with exact IMU samples: constant angular rate
    adot = 2 pi / (dt (n_loop - 1)) on the circle, centripetal world
    acceleration, gravity (0, -9.81, 0) (the loop lies in the XZ plane, Y
    up), body frame = camera frame. Draws from `rng` in the reference
    generator's order."""
    G = np.array([0.0, -9.81, 0.0], np.float32)
    world = make_loop_world(rng, n_points=n_points, wall_radius=wall_radius)
    R_wc, t_wc = loop_trajectory(n_frames, dt, radius=radius, n_loop=n_loop)
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]], np.float32)
    adot = 2.0 * np.pi / (dt * (n_loop - 1))
    spf = int(round(dt * imu_hz))
    dts = 1.0 / imu_hz
    imu = np.zeros((n_frames - 1, spf, 7), np.float32)
    vel = np.zeros((n_frames, 3), np.float32)
    for i in range(n_frames):
        a = adot * i * dt
        vel[i] = radius * adot * np.array([np.cos(a), 0.0, np.sin(a)])
    omega_w = np.array([0.0, -adot, 0.0], np.float32)
    for i in range(n_frames - 1):
        for k in range(spf):
            a = adot * (i * dt + k * dts)
            R = so3_exp(np.array([0.0, np.pi - a, 0.0], np.float32))
            acc_w = -radius * adot * adot * np.array([np.sin(a), 0.0, -np.cos(a)],
                                                     np.float32)
            acc_b = R.T @ (acc_w - G) + rng.normal(0, acc_noise, 3)
            gyr_b = R.T @ omega_w + rng.normal(0, gyro_noise, 3)
            imu[i, k] = np.concatenate([acc_b, gyr_b, [dts]])
    s = render_stereo_along(world, K, R_wc, t_wc, np.arange(n_frames) * dt, h, w, baseline)
    return StereoInertialSequence(s.imgs_l, s.imgs_r, s.ts, R_wc, t_wc, K, baseline, imu,
                                  imu_hz, vel)


class SensorNoise(NamedTuple):
    """Photometric degradation of the synthetic camera, in gray levels
    (0..255): Gaussian read noise, shot noise sigma = shot_scale * sqrt(I),
    optical blur, horizontal motion blur, an exposure oscillation, vignette
    falloff and moving occluder patches."""

    read_sigma: float = 0.0
    shot_scale: float = 0.0
    blur_sigma: float = 0.0
    motion_blur: int = 0
    gain_drift: float = 0.0
    gain_period: float = 40.0
    vignette: float = 0.0
    occluders: int = 0
    occluder_size: int = 40

    @property
    def active(self) -> bool:
        return (self.read_sigma > 0 or self.shot_scale > 0
                or self.blur_sigma > 0 or self.motion_blur > 0
                or self.gain_drift > 0 or self.vignette > 0
                or self.occluders > 0)


# ~2-4 gray levels of noise, mild blur, exposure and vignette drift and two
# moving occluders
DEFAULT_NOISE = SensorNoise(
    read_sigma=2.0, shot_scale=0.25, blur_sigma=0.6, gain_drift=0.12,
    vignette=0.25, occluders=2, occluder_size=36,
)


def degrade_images(imgs: np.ndarray, rng, noise: SensorNoise,
                   frame0: int = 0) -> np.ndarray:
    """Apply `noise` to a (T, H, W) float image stack in a camera's order:
    blur -> vignette and exposure -> occluders -> shot and read noise ->
    clip to 0..255. Deterministic given (rng, frame0)."""
    if not noise.active:
        return imgs
    from scipy.ndimage import gaussian_filter, uniform_filter1d

    T, h, w = imgs.shape
    out = imgs.astype(np.float32).copy()
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r2 = (((yy - h / 2) / (h / 2)) ** 2 + ((xx - w / 2) / (w / 2)) ** 2) / 2.0
    vig = 1.0 - noise.vignette * r2 if noise.vignette > 0 else None
    for t in range(T):
        img = out[t]
        if noise.blur_sigma > 0:
            img = gaussian_filter(img, noise.blur_sigma)
        if noise.motion_blur > 1:
            img = uniform_filter1d(img, noise.motion_blur, axis=1)
        if noise.gain_drift > 0:
            img = img * (1.0 + noise.gain_drift * np.sin(
                2.0 * np.pi * (frame0 + t) / noise.gain_period))
        if vig is not None:
            img = img * vig
        for _ in range(noise.occluders):
            s = noise.occluder_size
            y0 = rng.integers(0, max(h - s, 1))
            x0 = rng.integers(0, max(w - s, 1))
            tex = rng.uniform(20, 240, size=(max(s // 6, 1),) * 2)
            tex = np.kron(tex, np.ones((6, 6)))[:s, :s]
            img[y0:y0 + s, x0:x0 + s] = tex[:min(s, h - y0), :min(s, w - x0)]
        sigma = noise.read_sigma
        if noise.shot_scale > 0:
            sig_map = np.sqrt(sigma ** 2 + noise.shot_scale ** 2 * np.maximum(img, 0.0))
            img = img + rng.standard_normal(img.shape).astype(np.float32) * sig_map
        elif sigma > 0:
            img = img + rng.normal(0, sigma, img.shape).astype(np.float32)
        out[t] = np.clip(img, 0.0, 255.0)
    return out


def degrade_stereo(seq, rng, noise: SensorNoise = DEFAULT_NOISE):
    """Both eyes of a stereo(-inertial) sequence through `noise`, with
    independent draws (left first)."""
    return seq._replace(imgs_l=degrade_images(seq.imgs_l, rng, noise),
                        imgs_r=degrade_images(seq.imgs_r, rng, noise))


def perturb_imu(imu: np.ndarray, rng, gyro_noise: float = 0.004,
                acc_noise: float = 0.02, gyro_walk: float = 2e-5,
                acc_walk: float = 3e-4, gyro_bias0: float = 0.003,
                acc_bias0: float = 0.02) -> np.ndarray:
    """A copy of a clean (T-1, S, 7) IMU stack with white noise and
    random-walk biases added (EuRoC-class densities at 200 Hz)."""
    out = imu.copy()
    bg = rng.normal(0, gyro_bias0, 3)
    ba = rng.normal(0, acc_bias0, 3)
    for i in range(out.shape[0]):
        for k in range(out.shape[1]):
            dt = float(out[i, k, 6])
            if dt <= 0:
                continue
            ba = ba + rng.normal(0, acc_walk * np.sqrt(dt), 3)
            bg = bg + rng.normal(0, gyro_walk * np.sqrt(dt), 3)
            out[i, k, 0:3] += ba + rng.normal(0, acc_noise, 3)
            out[i, k, 3:6] += bg + rng.normal(0, gyro_noise, 3)
    return out


def load_gt_trajectory(path: str, n_frames: int = 0, stride: int = 1):
    """A ground-truth trajectory file in the EuRoC left-camera layout (CSV
    rows `timestamp_ns, p_xyz, q_wxyz`, `#` comments). Returns (ts (T,)
    float64 seconds from the first row, R_wc (T, 3, 3) float32, t_wc (T, 3)
    float32)."""
    rows = np.loadtxt(path, delimiter=",", comments="#")
    rows = rows[::stride]
    if n_frames:
        rows = rows[:n_frames]
    ts = (rows[:, 0] - rows[0, 0]) * 1e-9
    t_wc = rows[:, 1:4].astype(np.float32)
    w, x, y, z = rows[:, 4], rows[:, 5], rows[:, 6], rows[:, 7]
    R_wc = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=1).reshape(-1, 3, 3).astype(np.float32)
    return ts.astype(np.float64), R_wc, t_wc


def make_world_along_trajectory(rng, R_wc, t_wc, n_points=800,
                                depth_range=(2.5, 10.0), every=4) -> SyntheticWorld:
    """Sprites along random pixel rays of every `every`-th pose, at random
    depths, so every camera of an arbitrary trajectory sees structure."""
    n_anchor = max(1, len(R_wc) // every)
    per = max(1, n_points // n_anchor)
    pts = []
    for i in range(0, len(R_wc), every):
        d = rng.uniform(depth_range[0], depth_range[1], per)
        dx = rng.uniform(-0.6, 0.6, per)
        dy = rng.uniform(-0.45, 0.45, per)
        rays = np.stack([dx, dy, np.ones(per)], 1)
        rays /= np.linalg.norm(rays, axis=1, keepdims=True)
        pts.append(t_wc[i][None] + (R_wc[i] @ (rays * d[:, None]).T).T)
    pts = np.concatenate(pts).astype(np.float32)
    n = len(pts)
    tex = rng.uniform(70, 250, size=(n, TEX, TEX)).astype(np.float32)
    tex = np.repeat(np.repeat(tex[:, ::2, ::2], 2, axis=1), 2, axis=2)[:, :TEX, :TEX]
    return SyntheticWorld(points=pts,
                          sprite_size=rng.uniform(0.05, 0.14, n).astype(np.float32),
                          sprite_tex=tex)


def make_gt_stereo_sequence(rng, gt_path: str, n_frames=40, stride=4, h=240, w=352,
                            fx=260.0, baseline=0.2, n_points=900,
                            depth_range=(2.5, 10.0)) -> StereoSequence:
    """A stereo sequence rendered along a ground-truth trajectory file."""
    ts, R_wc, t_wc = load_gt_trajectory(gt_path, n_frames=n_frames, stride=stride)
    world = make_world_along_trajectory(rng, R_wc, t_wc, n_points=n_points,
                                        depth_range=depth_range)
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]], np.float32)
    return render_stereo_along(world, K, R_wc, t_wc, ts, h, w, baseline)


def make_gt_stereo_inertial_sequence(rng, gt_path: str, n_frames=120, h=240, w=352,
                                     fx=260.0, baseline=0.2, n_points=2400,
                                     depth_range=(2.5, 10.0),
                                     imu_hz=200.0) -> StereoInertialSequence:
    """Stereo frames and synthesised IMU along a ground-truth trajectory
    file: a cubic spline through the positions gives the world acceleration,
    the rotation is slerped between samples (constant body rate per
    interval), gravity (0, 0, -9.81), body frame = camera frame."""
    from scipy.interpolate import CubicSpline

    ts, R_wc, t_wc = load_gt_trajectory(gt_path, n_frames=n_frames, stride=1)
    G = np.array([0.0, 0.0, -9.81], np.float32)
    cs = CubicSpline(ts, t_wc, axis=0)
    vel = cs(ts, 1).astype(np.float32)
    spf = int(round((ts[1] - ts[0]) * imu_hz))
    dts = 1.0 / imu_hz
    imu = np.zeros((n_frames - 1, spf, 7), np.float32)
    for i in range(n_frames - 1):
        for k in range(spf):
            t = ts[i] + k * dts
            a_w = cs(t, 2)
            j = min(int((t - ts[0]) / (ts[1] - ts[0])), n_frames - 2)
            alpha = (t - ts[j]) / (ts[j + 1] - ts[j])
            w_vec = so3_log((R_wc[j].T @ R_wc[j + 1]).astype(np.float32))
            R_t = R_wc[j] @ so3_exp((alpha * w_vec).astype(np.float32))
            omega_b = w_vec / (ts[j + 1] - ts[j])
            a_b = R_t.T @ (a_w - G)
            imu[i, k] = np.concatenate(
                [a_b.astype(np.float32), omega_b.astype(np.float32), [dts]])
    world = make_world_along_trajectory(rng, R_wc, t_wc, n_points=n_points,
                                        depth_range=depth_range)
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]], np.float32)
    s = render_stereo_along(world, K, R_wc, t_wc, ts, h, w, baseline)
    return StereoInertialSequence(s.imgs_l, s.imgs_r, s.ts, s.R_wc, s.t_wc, s.K,
                                  baseline, imu, imu_hz, vel)


class RGBDSequence(NamedTuple):
    imgs: np.ndarray     # (T, H, W)
    depths: np.ndarray   # (T, H, W) metric depth (-1 unknown)
    ts: np.ndarray
    R_wc: np.ndarray
    t_wc: np.ndarray
    K: np.ndarray


def render_depth_along(world, K, R_wc, t_wc, h, w):
    """Gray images and dense depth maps (-1 where no sprite) at every pose."""
    n = len(R_wc)
    imgs = np.zeros((n, h, w), np.float32)
    depths = np.zeros((n, h, w), np.float32)
    for i in range(n):
        R_cw = R_wc[i].T
        imgs[i], depths[i] = render(world, K, R_cw, -R_cw @ t_wc[i], h, w,
                                    return_depth=True)
    return imgs, depths


def make_rgbd_sequence(rng, n_frames=30, h=240, w=352, fx=260.0, dt=0.05,
                       speed=(0.8, 0.0, 0.12), yaw_rate=0.06, world=None) -> RGBDSequence:
    """Gray and dense-depth frames along the orbit trajectory (the RGBD
    sensor mode)."""
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]], np.float32)
    if world is None:
        world = make_world(rng)
    R_wc, t_wc = orbit_trajectory(n_frames, dt, speed=speed, yaw_rate=yaw_rate)
    imgs, depths = render_depth_along(world, K, R_wc, t_wc, h, w)
    return RGBDSequence(imgs, depths, np.arange(n_frames) * dt, R_wc, t_wc, K)
