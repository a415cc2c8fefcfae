"""The port's MonoInertialTracker against the JAX package's on the twin of
tests/test_e2e_mono_inertial.py (40 frames of 352x240 with 200 Hz IMU, 400
features, 4 levels, accel_amp 0.8; IMU init after 8 keyframes and 1.2 s,
free scale).

Tolerances (the JAX test's bars, scored on the frames after the first
keyframe of the IMU chain): both trackers end OK with the IMU initialised;
the port's metric ATE (no scale alignment) < 0.15 m, its Horn scale within
0.12 of 1, and the scale-aligned ATE no larger than the metric one; the
port's metric ATE within 1.5x + 5 mm of the JAX tracker's on the same
frames.
"""

import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu.evaluation import ate as jate
from orb_slam3_vio_fixes_tpu.frontend import inertial_tracking as jit
from orb_slam3_vio_fixes_tpu.frontend import tracking as jtr
from orb_slam3_vio_fixes_tpu.imu import preintegration as jpre
from orb_slam3_vio_fixes_tpu.io import synthetic as jsyn
from orb_slam3_vio_fixes_tpu.ops import orb as jorb
from orb_slam3_vio_fixes_tpu.slam_map import map_state as jms
from orb_slam3_vio_fixes_tpu.utils.cameras import Camera as JCamera
from orb_slam3_vio_fixes_tpu_torch.frontend import inertial_tracking as tit
from orb_slam3_vio_fixes_tpu_torch.frontend import tracking as ttr
from orb_slam3_vio_fixes_tpu_torch.imu import preintegration as tpre
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera as TCamera

from test_torch_slice import port_cfg

torch.set_num_threads(2)

ICFG = dict(frame_samples=16, kf_samples=256, init_min_kfs=8, init_min_time=1.2,
            vi_window=6, max_local_lm=1024, fix_scale=False)


@pytest.fixture(scope="module")
def seq():
    """tests/test_e2e_mono_inertial.py's sequence (the JAX generator)."""
    rng = np.random.default_rng(11)
    world = jsyn.make_world(rng, n_points=700, extent=7.0, depth_range=(2.5, 9.0))
    return jsyn.make_stereo_inertial_sequence(rng, n_frames=40, h=240, w=352, fx=260.0,
                                              baseline=0.2, world=world, imu_hz=200.0,
                                              accel_amp=0.8)


def jax_cfg(seq):
    return jtr.TrackerConfig(
        orb=jorb.ORBConfig(n_features=400, n_levels=4),
        map=jms.MapConfig(max_keyframes=32, max_landmarks=4096, max_features=400),
        width=seq.imgs_l.shape[2], height=seq.imgs_l.shape[1], max_local_lm=1024,
        ba_window=6, ba_fixed=2, new_lm_budget=256, max_frames_between_kf=6)


def _run(tr, seq, process):
    for i in range(seq.imgs_l.shape[0]):
        imu = seq.imu[i - 1] if i > 0 else np.zeros((0, 7), np.float32)
        process(seq.imgs_l[i], seq.ts[i], imu)
    est = [x for x in tr.trajectory if x[0] >= tr.t_first_kf]
    est_ts = np.array([x[0] for x in est])
    est_pos = np.array([-x[1].T @ x[2] for x in est])
    metric, _, n = jate.ate_rmse(seq.ts, seq.t_wc, est_ts, est_pos, with_scale=False)
    aligned, scale, _ = jate.ate_rmse(seq.ts, seq.t_wc, est_ts, est_pos, with_scale=True)
    return metric, aligned, scale, n


def test_mono_inertial_metric_scale_like_reference(seq):
    K = seq.K
    c = (K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    cfg = jax_cfg(seq)
    jt = jit.MonoInertialTracker(JCamera.pinhole(*c),
                                 jpre.ImuCalib.make(1.7e-4, 2e-3, 1.9e-5, 3e-3, seq.imu_hz),
                                 cfg, jit.InertialConfig(**ICFG))
    tt = tit.MonoInertialTracker(TCamera.pinhole(*c),
                                 tpre.ImuCalib.make(1.7e-4, 2e-3, 1.9e-5, 3e-3, seq.imu_hz,
                                                    device="cpu"),
                                 port_cfg(cfg), tit.InertialConfig(**ICFG), device="cpu")
    ref = _run(jt, seq, jt.process_mono_inertial)
    got = _run(tt, seq, tt.process_mono_inertial)
    assert jt.track_state == tt.track_state == ttr.TrackState.OK
    assert jt.imu_ready and tt.imu_ready
    metric, aligned, scale, n = got
    assert n >= 10
    assert metric < 0.15, f"mono-inertial metric ATE {metric:.3f} m: scale not recovered"
    assert abs(scale - 1.0) < 0.12, f"scale error {scale:.3f}"
    assert aligned <= metric + 1e-6
    assert metric <= 1.5 * ref[0] + 0.005, (got, ref)


def test_mono_inertial_refuses_fixed_scale():
    with pytest.raises(ValueError, match="fix_scale"):
        tit.MonoInertialTracker(TCamera.pinhole(260.0, 260.0, 176.0, 120.0),
                                tpre.ImuCalib.make(1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0,
                                                   device="cpu"),
                                ttr.TrackerConfig(width=352, height=240),
                                tit.InertialConfig(fix_scale=True), device="cpu")


@pytest.mark.slow
def test_jax_mono_inertial_reference_at_full_width():
    """Where chip_smoke.JAX_MI_ATE_M comes from: the JAX package's
    MonoInertialTracker on phase 17's frames (this test's scene generator at
    752x480, fx 458, 1024 features, 60 frames), scored as phase 17 does, on
    the CPU. Several minutes."""
    import jax

    import chip_smoke
    from test_torch_mono import jax_config_of

    seq = chip_smoke.make_mono_inertial_sequence(jsyn)
    K = seq.K
    jt = jit.MonoInertialTracker(
        JCamera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
        jpre.ImuCalib.make(1.7e-4, 2e-3, 1.9e-5, 3e-3, seq.imu_hz),
        jax_config_of(chip_smoke.tracker_config(seq, max_frames_between_kf=6)),
        jit.InertialConfig(**chip_smoke.MI_ICFG))
    for i in range(seq.imgs_l.shape[0]):
        imu = seq.imu[i - 1] if i > 0 else np.zeros((0, 7), np.float32)
        jt.process_mono_inertial(seq.imgs_l[i], seq.ts[i], imu)
    metric, aligned, scale, n = chip_smoke.mono_scores(seq.ts, seq.t_wc, jt.trajectory,
                                                       jt.t_first_kf)
    jax.clear_caches()
    print(f"jax mono-inertial at 752x480: state={jt.track_state} imu_ready={jt.imu_ready} "
          f"keyframes={len(jt.kf_order)} metric_ate_m={metric!r} aligned_ate_m={aligned!r} "
          f"horn_scale={scale!r} frames={n}")
    assert jt.track_state == "OK" and jt.imu_ready
    assert abs(metric - chip_smoke.JAX_MI_ATE_M) < 1e-6, metric
