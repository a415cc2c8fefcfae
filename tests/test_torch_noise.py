"""The port's sensor-noise model and the twins of tests/test_noise_robustness.py.

Tolerances and why:
  * `degrade_images`, `degrade_stereo`, `perturb_imu`: byte-equal to the JAX
    package's on the same seed, and the generator left in the same state
    (the same numpy and scipy calls in the same order);
  * the four descriptor match-rate tests: the JAX test's own bars, on the
    port's `orb.extract` and `matching.match_descriptors` (CPU: the plain
    twins of K1 and K2);
  * the slow tracking run: the JAX test's bar, noisy ATE below
    max(2 x clean ATE, 0.02 m), on the port's StereoTracker.
"""

import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu.io import synthetic as jsyn
from orb_slam3_vio_fixes_tpu_torch import lifetime
from orb_slam3_vio_fixes_tpu_torch.io import synthetic as tsyn
from orb_slam3_vio_fixes_tpu_torch.ops import matching, orb

torch.set_num_threads(2)

CFG = orb.ORBConfig(n_features=400, n_levels=4)

NOISES = {
    "default": "DEFAULT_NOISE",
    "read": dict(read_sigma=3.0),
    "blur_motion_gain": dict(blur_sigma=1.1, motion_blur=5, gain_drift=0.2,
                             gain_period=7.0),
    "vignette_occluders": dict(vignette=0.4, occluders=3, occluder_size=24),
    "inactive": dict(),
}


def _noise(mod, name):
    spec = NOISES[name]
    return getattr(mod, spec) if isinstance(spec, str) else mod.SensorNoise(**spec)


@pytest.mark.parametrize("name", list(NOISES))
def test_degrade_images_byte_equal(name):
    imgs = np.random.default_rng(4).uniform(0, 255, (3, 48, 64)).astype(np.float32)
    outs, nexts = [], []
    for mod in (jsyn, tsyn):
        rng = np.random.default_rng(11)
        outs.append(mod.degrade_images(imgs, rng, _noise(mod, name), frame0=5))
        nexts.append(rng.integers(0, 2**62))
    assert outs[0].dtype == outs[1].dtype
    np.testing.assert_array_equal(outs[1], outs[0])
    assert nexts[0] == nexts[1]
    assert tsyn.DEFAULT_NOISE._asdict() == jsyn.DEFAULT_NOISE._asdict()


def test_degrade_stereo_and_perturb_imu_byte_equal():
    rng = np.random.default_rng(5)
    seq = jsyn.make_stereo_inertial_sequence(
        rng, n_frames=3, h=40, w=56, fx=40.0, baseline=0.2,
        world=jsyn.make_world(rng, n_points=40), imu_hz=200.0)
    outs = []
    for mod in (jsyn, tsyn):
        r = np.random.default_rng(13)
        s = mod.degrade_stereo(seq, r)
        outs.append((s.imgs_l, s.imgs_r, mod.perturb_imu(seq.imu, r), r.integers(0, 2**62)))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)
    assert not np.array_equal(outs[1][2], seq.imu)


def _render_frame(seed=3, h=240, w=352):
    rng = np.random.default_rng(seed)
    world = tsyn.make_world(rng, n_points=500, extent=7.0, depth_range=(2.5, 9.0))
    K = np.array([[260.0, 0, w / 2], [0, 260.0, h / 2], [0, 0, 1]], np.float32)
    return tsyn.render(world, K, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), h, w)


@pytest.fixture(scope="module")
def frame():
    return _render_frame()


def _match_rate(img_a, img_b, uv_map=None, tol=2.0):
    """The JAX test's mutual-match rate, through the port's extractor and
    matcher: matches that land within `tol` px of where `uv_map` puts them,
    over the valid keypoints of image a."""
    fa = orb.extract(torch.as_tensor(np.asarray(img_a, np.float32)), CFG)
    fb = orb.extract(torch.as_tensor(np.asarray(img_b, np.float32)), CFG)
    res = matching.match_descriptors(fa.desc, fa.valid, fb.desc, fb.valid, ratio=0.8,
                                     max_dist=matching.TH_LOW, mutual=True)
    idx = res.idx.numpy()
    va = fa.valid.numpy()
    uva, uvb = fa.uv.numpy(), fb.uv.numpy()
    matched = (idx >= 0) & va
    pred = uva if uv_map is None else uv_map(uva)
    d = np.linalg.norm(uvb[np.clip(idx, 0, len(uvb) - 1)] - pred, axis=1)
    return ((matched & (d < tol)).sum()) / max(va.sum(), 1)


def test_descriptor_match_rate_under_noise(frame):
    deg = tsyn.degrade_images(frame[None], np.random.default_rng(11), tsyn.DEFAULT_NOISE)[0]
    rate = _match_rate(frame, deg)
    assert rate > 0.35, f"match rate under default noise collapsed: {rate:.2f}"


def test_descriptor_match_rate_noise_sweep(frame):
    rates = []
    for sigma in (1.0, 2.0, 4.0):
        deg = tsyn.degrade_images(frame[None], np.random.default_rng(13),
                                  tsyn.SensorNoise(read_sigma=sigma))[0]
        rates.append(_match_rate(frame, deg))
    assert rates[0] > 0.5, rates
    assert rates[2] > 0.3, rates
    assert rates[2] > 0.4 * rates[0], f"cliff between sigmas: {rates}"


def test_descriptor_match_rate_under_rotation(frame):
    from scipy.ndimage import rotate

    ang = 12.0
    rot = rotate(frame, ang, reshape=False, order=1, mode="nearest")
    h, w = frame.shape
    c = np.array([w / 2 - 0.5, h / 2 - 0.5])
    th = np.deg2rad(ang)
    Rm = np.array([[np.cos(th), np.sin(th)], [-np.sin(th), np.cos(th)]])
    rate = _match_rate(frame, rot, uv_map=lambda uv: (uv - c) @ Rm.T + c, tol=3.0)
    assert rate > 0.25, f"rotation match rate collapsed: {rate:.2f}"


def test_descriptor_match_rate_under_scale(frame):
    from scipy.ndimage import zoom as ndzoom

    h, w = frame.shape
    s = 1.25
    big = ndzoom(frame, s, order=1)
    y0, x0 = (big.shape[0] - h) // 2, (big.shape[1] - w) // 2
    crop = big[y0:y0 + h, x0:x0 + w]
    rate = _match_rate(frame, crop, uv_map=lambda uv: uv * s - np.array([x0, y0]), tol=3.0)
    assert rate > 0.2, f"scale match rate collapsed: {rate:.2f}"


@pytest.mark.slow
def test_stereo_tracking_survives_noise():
    """The JAX test's 24-frame scene clean and degraded, through
    lifetime.noise_run (chip phase 22 runs the same function on the card)."""
    out = lifetime.noise_run("cpu")
    assert not out["failed"], out
