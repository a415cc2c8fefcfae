"""The generator's ground truth: the stereo-inertial flight's IMU samples,
preintegrated, give back its poses and velocities, and carry the
configuration's noise; the biases it reports are those in the samples; a
blackout shows nothing."""

import json
import math

import numpy as np
import pytest

from slam_bench import scene
from slam_bench.tests import tiny

ROOT = tiny.ROOT


def explore():
    t = json.loads((ROOT / "slam_bench/traffic/explore.json").read_text())
    c = json.loads((ROOT / "slam_bench/configs/euroc_stereo_inertial.json").read_text())
    return t, c


def preintegrate(samples):
    """(dR, dv, dp) of body-frame specific force and rate samples, each
    held over its dt (Euler, as the generator integrates)."""
    dR, dv, dp = np.eye(3), np.zeros(3), np.zeros(3)
    for a, w, dt in zip(samples[:, :3].astype(np.float64), samples[:, 3:6].astype(np.float64),
                        samples[:, 6].astype(np.float64)):
        dp = dp + dv * dt + 0.5 * (dR @ a) * dt * dt
        dv = dv + (dR @ a) * dt
        dR = dR @ scene.so3_exp(w * dt)
    return dR, dv, dp


def test_imu_samples_give_back_the_poses():
    t, c = explore()
    quiet = dict(c["imu"], noise_gyro=0.0, noise_acc=0.0, walk_gyro=0.0, walk_acc=0.0)
    n = 60
    R_wc, t_wc, v_w, bias, imu = scene.path(t["path"], n, quiet, np.random.default_rng(0))
    g = scene.G_WORLD
    v = np.asarray(t["path"]["v0"], np.float64)
    assert imu[0].shape == (0, 7) and not bias.any()
    for i in range(n - 1):
        s = imu[i + 1]
        assert s.shape == (10, 7)
        T = float(s[:, 6].astype(np.float64).sum())
        dR, dv, dp = preintegrate(s)
        np.testing.assert_allclose(R_wc[i] @ dR, R_wc[i + 1], atol=1e-6)
        p_next = t_wc[i] + v * T + 0.5 * g * T * T + R_wc[i] @ dp
        np.testing.assert_allclose(p_next, t_wc[i + 1], atol=2e-5)
        v = v + g * T + R_wc[i] @ dv
        np.testing.assert_allclose(v, v_w[i + 1], atol=2e-5)
    assert np.linalg.norm(t_wc[-1] - t_wc[0]) > 1.0


def test_imu_noise_at_the_configurations_densities():
    t, c = explore()
    n = 400
    quiet = dict(c["imu"], noise_gyro=0.0, noise_acc=0.0, walk_gyro=0.0, walk_acc=0.0)
    clean = scene.path(t["path"], n, quiet, np.random.default_rng(4))[-1]
    white = dict(c["imu"], walk_gyro=0.0, walk_acc=0.0)
    noisy = scene.path(t["path"], n, white, np.random.default_rng(4))[-1]
    d = np.concatenate(noisy[1:]) - np.concatenate(clean[1:])
    sq = math.sqrt(c["imu"]["rate_hz"])
    assert np.std(d[:, :3]) == pytest.approx(c["imu"]["noise_acc"] * sq, rel=0.05)
    assert np.std(d[:, 3:6]) == pytest.approx(c["imu"]["noise_gyro"] * sq, rel=0.05)


def test_biases_are_those_in_the_samples():
    t, c = explore()
    n = 40
    quiet = dict(c["imu"], noise_gyro=0.0, noise_acc=0.0, walk_gyro=0.0, walk_acc=0.0)
    walk = dict(quiet, walk_gyro=c["imu"]["walk_gyro"], walk_acc=c["imu"]["walk_acc"])
    clean = scene.path(t["path"], n, quiet, np.random.default_rng(5))[-1]
    _, _, _, bias, drifted = scene.path(t["path"], n, walk, np.random.default_rng(5))
    for i in range(n - 1):
        # the first sample after frame i carries frame i's bias
        d = drifted[i + 1][0, :6].astype(np.float64) - clean[i + 1][0, :6]
        np.testing.assert_allclose(d, bias[i], atol=1e-5)
    assert np.abs(bias[-1]).max() > 0


def test_a_blackout_shows_nothing():
    traffic = tiny.tiny_traffic("explore")
    traffic["blackout"] = [[2, 4]]
    traffic["noise_sigma"] = 0.0
    config = json.loads((ROOT / "slam_bench/configs/euroc_stereo.json").read_text())
    config["camera"].update(width=64, height=48, fx=40.0, fy=40.0, cx=32.0, cy=24.0)
    s = scene.make(traffic, config, 3, 0.25, 4, "cpu")
    assert len(s.ts) == traffic["warmup"]["max_frames"] + 1
    assert s.imu is None
    assert not s.imgs[2:4].any()
    assert s.imgs[1].any() and s.imgs[4].any()
