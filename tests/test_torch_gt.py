"""The port's ground-truth-trajectory generators against the JAX package's, on
a trajectory file this test writes in the EuRoC left-camera layout, and the
port's twins of tests/test_e2e_gt.py and tests/test_e2e_gt_inertial.py.

Tolerances and why:
  * `load_gt_trajectory`, `make_world_along_trajectory`,
    `make_gt_stereo_sequence`: float32-exact (the same numpy arithmetic);
  * `make_gt_stereo_inertial_sequence`: images, poses and velocities exact;
    the IMU samples within one float32 ulp, because the body rates and the
    slerped rotation go through so3_log / so3_exp, which the reference
    evaluates with XLA's float32 sin, cos and arccos and the port with
    numpy's (the two disagree in the last bit on 11-42% of inputs); the
    port's `so3_log` itself within 4 float32 spacings of the angle plus
    1e-7 of the reference's, its small-angle, generic and near-pi branches;
  * the end-to-end twins: the JAX tests' own bars. They need the reference's
    ground-truth files, which are not in the repository: they skip on the
    same condition as the JAX files (their `GT_DIR`).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu.io import synthetic as jsyn
from orb_slam3_vio_fixes_tpu.utils import lie as jlie
from orb_slam3_vio_fixes_tpu_torch.evaluation import ate
from orb_slam3_vio_fixes_tpu_torch.frontend import inertial_tracking as it
from orb_slam3_vio_fixes_tpu_torch.frontend import tracking
from orb_slam3_vio_fixes_tpu_torch.imu import preintegration as pre
from orb_slam3_vio_fixes_tpu_torch.io import synthetic as tsyn
from orb_slam3_vio_fixes_tpu_torch.ops import orb
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera

from test_e2e_gt import GT_DIR

torch.set_num_threads(2)

needs_gt = pytest.mark.skipif(not os.path.isdir(GT_DIR),
                              reason="reference GT files not available")


@pytest.fixture(scope="module")
def gt_file(tmp_path_factory):
    """30 rows at 20 Hz: a smooth path and a rotation sweeping 2.8 rad about
    a fixed random axis, quaternions written w first."""
    rng = np.random.default_rng(0)
    n = 30
    t = np.arange(n) * 0.05
    ts_ns = 1403636579763555584 + np.round(t * 1e9).astype(np.int64)
    pos = np.stack([np.sin(t), 0.3 * t, np.cos(0.7 * t)], 1)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = np.linspace(0.0, 2.8, n)
    q = np.concatenate([np.cos(ang / 2)[:, None], np.sin(ang / 2)[:, None] * axis], 1)
    path = tmp_path_factory.mktemp("gt") / "SEQ_GT.txt"
    with open(path, "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
                "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []\n")
        for a, p, qq in zip(ts_ns, pos, q):
            f.write(f"{a}," + ",".join(f"{v:.9f}" for v in (*p, *qq)) + "\n")
    return str(path)


def _exact(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(y, x, err_msg=f)


def test_load_gt_trajectory_and_world(gt_file):
    for kw in (dict(), dict(n_frames=11, stride=2)):
        ref = jsyn.load_gt_trajectory(gt_file, **kw)
        got = tsyn.load_gt_trajectory(gt_file, **kw)
        for x, y in zip(ref, got):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(y, x)
    ts, R_wc, t_wc = ref
    _exact(jsyn.make_world_along_trajectory(np.random.default_rng(4), R_wc, t_wc, n_points=90),
           tsyn.make_world_along_trajectory(np.random.default_rng(4), R_wc, t_wc, n_points=90))


def test_make_gt_stereo_sequence(gt_file):
    kw = dict(n_frames=5, stride=3, h=60, w=88, fx=65.0, n_points=100)
    _exact(jsyn.make_gt_stereo_sequence(np.random.default_rng(3), gt_file, **kw),
           tsyn.make_gt_stereo_sequence(np.random.default_rng(3), gt_file, **kw))


def test_make_gt_stereo_inertial_sequence(gt_file):
    kw = dict(n_frames=3, h=60, w=88, fx=65.0, n_points=90)
    ref = jsyn.make_gt_stereo_inertial_sequence(np.random.default_rng(3), gt_file, **kw)
    got = tsyn.make_gt_stereo_inertial_sequence(np.random.default_rng(3), gt_file, **kw)
    for f in ref._fields:
        x, y = getattr(ref, f), getattr(got, f)
        if f == "imu":
            assert x.dtype == y.dtype == np.float32 and x.shape == y.shape == (2, 10, 7)
            np.testing.assert_array_max_ulp(y, x, maxulp=1)
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(y, x, err_msg=f)
        else:
            assert x == y, f


def test_so3_log_matches_reference():
    rng = np.random.default_rng(5)
    for scale in (1e-7, 1e-3, 0.5, 2.0, np.pi - 2e-4):
        for _ in range(8):
            axis = rng.normal(size=3)
            w = (axis / np.linalg.norm(axis) * scale).astype(np.float32)
            R = tsyn.so3_exp(w)
            ref = np.asarray(jlie.so3_log(jnp.asarray(R)))
            got = tsyn.so3_log(R)
            assert got.dtype == np.float32
            atol = 4 * np.spacing(np.float32(scale)) + 1e-7
            np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


# --- twins of tests/test_e2e_gt.py and tests/test_e2e_gt_inertial.py --------

def _cfg(max_kf=64, mbk=5):
    return tracking.TrackerConfig(
        orb=orb.ORBConfig(n_features=400, n_levels=4),
        map=ms.MapConfig(max_keyframes=max_kf, max_landmarks=8192, max_features=400),
        width=352, height=240, max_local_lm=2048, ba_window=6, ba_fixed=2,
        new_lm_budget=256, max_frames_between_kf=mbk)


def _cam(seq):
    return Camera.pinhole(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2])


def _est(tr, t_from=-np.inf):
    est = [x for x in tr.trajectory if x[0] >= t_from]
    return np.array([x[0] for x in est]), np.array([-x[1].T @ x[2] for x in est])


def _run_gt(gt_name, n_frames=120, stride=1, ate_bound=0.05):
    seq = tsyn.make_gt_stereo_sequence(
        np.random.default_rng(3), os.path.join(GT_DIR, gt_name), n_frames=n_frames,
        stride=stride, h=240, w=352, fx=260.0, baseline=0.2, n_points=20 * n_frames)
    tr = tracking.StereoTracker(_cam(seq), seq.K[0, 0] * seq.baseline, _cfg(), device="cpu")
    tr.match_radius = (12.0, 24.0)
    for i in range(seq.imgs_l.shape[0]):
        tr.process_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
    assert tr.track_state == tracking.TrackState.OK
    rmse, _, n = ate.ate_rmse(seq.ts, seq.t_wc, *_est(tr))
    assert n == len(seq.ts)
    assert rmse < ate_bound, f"{gt_name}: ATE {rmse:.4f} >= {ate_bound}"


@needs_gt
def test_gt_mh01_stereo_ate():
    _run_gt("MH01_GT.txt")


@needs_gt
@pytest.mark.slow
@pytest.mark.parametrize("name,bound", [("V101_GT.txt", 0.05), ("MH03_GT.txt", 0.08),
                                        ("MH05_GT.txt", 0.05), ("V201_GT.txt", 0.05)])
def test_gt_stereo_ate(name, bound):
    _run_gt(name, ate_bound=bound)


def _gt_inertial(n_frames=120, noisy=False):
    seq = tsyn.make_gt_stereo_inertial_sequence(
        np.random.default_rng(3), os.path.join(GT_DIR, "MH01_GT.txt"), n_frames=n_frames,
        h=240, w=352, fx=260.0, baseline=0.2, n_points=20 * n_frames)
    if noisy:
        rng = np.random.default_rng(13)
        seq = tsyn.degrade_stereo(seq, rng)
        seq = seq._replace(imu=tsyn.perturb_imu(seq.imu, rng))
    return seq


def _imu(seq, i):
    return seq.imu[i - 1] if i > 0 else np.zeros((0, 7), np.float32)


@needs_gt
@pytest.mark.slow
@pytest.mark.parametrize("noisy,bound", [(False, 0.05), (True, 0.10)])
def test_gt_mh01_stereo_inertial_ate(noisy, bound):
    seq = _gt_inertial(noisy=noisy)
    icfg = it.InertialConfig(frame_samples=16, kf_samples=256, init_min_kfs=6,
                             init_min_time=1.0, vi_window=6, max_local_lm=1024,
                             fix_scale=True)
    calib = pre.ImuCalib.make(1.7e-4, 2e-3, 1.9e-5, 3e-3, seq.imu_hz, device="cpu")
    tr = it.StereoInertialTracker(_cam(seq), seq.K[0, 0] * seq.baseline, calib, _cfg(),
                                  icfg, device="cpu")
    tr.match_radius = (12.0, 24.0)
    for i in range(seq.imgs_l.shape[0]):
        tr.process_stereo_inertial(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i], _imu(seq, i))
    assert tr.track_state == tracking.TrackState.OK and tr.imu_ready
    rmse, _, n = ate.ate_rmse(seq.ts, seq.t_wc, *_est(tr))
    assert n == len(seq.ts)
    assert rmse < bound, f"stereo-inertial MH01 ATE {rmse:.4f} (noisy={noisy})"


@needs_gt
@pytest.mark.slow
def test_gt_mh01_mono_inertial_metric():
    seq = _gt_inertial(n_frames=160)
    icfg = it.InertialConfig(frame_samples=16, kf_samples=256, init_min_kfs=8,
                             init_min_time=2.0, vi_window=6, max_local_lm=1024,
                             fix_scale=False)
    calib = pre.ImuCalib.make(1.7e-4, 2e-3, 1.9e-5, 3e-3, seq.imu_hz, device="cpu")
    tr = it.MonoInertialTracker(_cam(seq), calib, _cfg(), icfg, device="cpu")
    for i in range(seq.imgs_l.shape[0]):
        tr.process_mono_inertial(seq.imgs_l[i], seq.ts[i], _imu(seq, i))
    assert tr.track_state == tracking.TrackState.OK and tr.imu_ready
    est_ts, est_pos = _est(tr, tr.t_first_kf)
    rmse, _, n = ate.ate_rmse(seq.ts, seq.t_wc, est_ts, est_pos, with_scale=False)
    assert n >= 40
    assert rmse < 0.30, f"mono-inertial MH01 metric ATE {rmse:.4f}"
    _, scale, _ = ate.ate_rmse(seq.ts, seq.t_wc, est_ts, est_pos, with_scale=True)
    assert abs(scale - 1.0) < 0.25, f"scale error {scale:.3f}"
