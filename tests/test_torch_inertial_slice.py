"""The port's stereo-inertial tracker (sync mode) against the JAX package's
on the tests/test_e2e_inertial.py scene and configuration (36 frames of
240x352, 400 features, 4 levels, IMU at 200 Hz), and the port alone under
that test's own bars.

Tolerances:
- the same live keyframe count after every frame, and the IMU initialised
  at the same frame (keyframe decisions are integer thresholds on counts
  both sides compute alike);
- camera centres of the per-frame returned poses within 5 mm before the IMU
  initialisation (the visual slice's bar) and within 0.05 m over all 36
  frames: after it, float32 differences in the last bits grow through the
  joint visual-inertial solves, in both packages;
- the IMU initialisation (preintegration, gravity bootstrap, inertial-only
  LM, map alignment, window VI BA, full-map VI BA) run by the port from the
  JAX tracker's own pre-init state: keyframe centres within 0.1 mm,
  velocities within 1e-3 m/s, biases within 1e-5, landmarks within 5 mm
  (landmark row 0 left out: the reference's compacted write-back reverts
  it);
- the port's ATE < 0.03 m, >= 2 window VI BAs and the final speed within
  25% of the true one, test_e2e_inertial's bars; after a bad-IMU reset the
  recorded trajectory is unchanged (to 1e-9 m) and the next frame
  initialises a new map.
"""


import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu.frontend import inertial_tracking as jit_
from orb_slam3_vio_fixes_tpu.frontend import tracking as jtr
from orb_slam3_vio_fixes_tpu.imu import preintegration as jpre
from orb_slam3_vio_fixes_tpu.io import synthetic as jsyn
from orb_slam3_vio_fixes_tpu.ops import orb as jorb
from orb_slam3_vio_fixes_tpu.slam_map import map_state as jms
from orb_slam3_vio_fixes_tpu.utils.cameras import Camera as JCamera
from orb_slam3_vio_fixes_tpu_torch import convert
from orb_slam3_vio_fixes_tpu_torch.evaluation import ate
from orb_slam3_vio_fixes_tpu_torch.frontend import inertial_tracking as tit
from orb_slam3_vio_fixes_tpu_torch.frontend import tracking as ttr
from orb_slam3_vio_fixes_tpu_torch.imu import preintegration as tpre
from orb_slam3_vio_fixes_tpu_torch.runtime import tracing
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera as TCamera

from test_torch_slice import port_cfg

torch.set_num_threads(2)


N_FRAMES = 36
IMU_NOISE = (1.7e-4, 2e-3, 1.9e-5, 3e-3)


@pytest.fixture(scope="module")
def seq():
    rng = np.random.default_rng(5)
    world = jsyn.make_world(rng, n_points=600, extent=7.0, depth_range=(2.5, 9.0))
    return jsyn.make_stereo_inertial_sequence(
        rng, n_frames=N_FRAMES, h=240, w=352, fx=260.0, baseline=0.2, world=world,
        imu_hz=200.0, accel_amp=0.6)


def jax_configs(seq):
    cfg = jtr.TrackerConfig(
        orb=jorb.ORBConfig(n_features=400, n_levels=4),
        map=jms.MapConfig(max_keyframes=32, max_landmarks=4096, max_features=400),
        width=seq.imgs_l.shape[2], height=seq.imgs_l.shape[1], max_local_lm=1024,
        ba_window=6, ba_fixed=2, new_lm_budget=256, max_frames_between_kf=6)
    icfg = jit_.InertialConfig(frame_samples=16, kf_samples=128, init_min_kfs=4,
                               init_min_time=0.5, vi_window=6, max_local_lm=1024,
                               fix_scale=True)
    return cfg, icfg


def port_tracker(seq):
    cfg, icfg = jax_configs(seq)
    K = seq.K
    return tit.StereoInertialTracker(
        TCamera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), K[0, 0] * seq.baseline,
        tpre.ImuCalib.make(*IMU_NOISE, seq.imu_hz, device="cpu"), port_cfg(cfg),
        tit.InertialConfig(**{f: getattr(icfg, f) for f in tit.InertialConfig._fields}),
        device="cpu")


def drive(tr, seq):
    """Every frame through process_stereo_inertial; per frame the returned
    camera centre, the live keyframe count and imu_ready."""
    out = []
    for i in range(N_FRAMES):
        imu = seq.imu[i - 1] if i > 0 else np.zeros((0, 7), np.float32)
        R, t, _ = tr.process_stereo_inertial(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i], imu)
        R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
        out.append((-R.T @ t, len(tr.kf_order), bool(tr.imu_ready)))
    return out


def _map_copy(state) -> dict:
    # copies: the JAX mapping functions donate (and so reuse) their input state
    return {f: np.array(getattr(state, f), copy=True) for f in jms.MapState._fields}


@pytest.fixture(scope="module")
def jax_run(seq):
    """The reference tracker over every frame, with its map and IMU windows
    captured on entry to and return from the IMU initialisation."""
    cfg, icfg = jax_configs(seq)
    K = seq.K
    tr = jit_.StereoInertialTracker(
        JCamera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), K[0, 0] * seq.baseline,
        jpre.ImuCalib.make(*IMU_NOISE, seq.imu_hz), cfg, icfg)
    init = {}
    real = tr._initialize_imu

    def captured():
        init["before"] = (_map_copy(tr.state), dict(tr.kf_windows), list(tr.kf_order),
                          tr.n_kf, tr.n_lm)
        real()
        init["after"] = _map_copy(tr.state)

    tr._initialize_imu = captured
    return tr, drive(tr, seq), init


KF_STATE = ("kf_valid", "kf_R", "kf_t", "kf_vel", "kf_bg", "kf_ba")


def run_end(tr) -> dict:
    """Copies of the trajectory and the keyframes' states (later tests go
    on with the tracker)."""
    return {"traj": tr.trajectory, "n_vi_ba": tr.n_vi_ba,
            **{f: getattr(tr.state, f).clone() for f in KF_STATE}}


@pytest.fixture(scope="module")
def port_traced(seq):
    """The port over every frame under a tracer: (tracker, drive's
    outputs, the tracer's counters, run_end)."""
    tr = port_tracker(seq)
    with tracing.traced(tracing.Tracer()) as tc:
        out = drive(tr, seq)
    return tr, out, tc.counters, run_end(tr)


@pytest.fixture(scope="module")
def port_run(port_traced):
    return port_traced[:2]


def test_tracks_like_reference(jax_run, port_run):
    _, ref, _ = jax_run
    _, got = port_run
    assert [r[1] for r in got] == [r[1] for r in ref]
    assert [r[2] for r in got] == [r[2] for r in ref]
    assert any(r[2] for r in ref) and not ref[0][2]
    d = np.linalg.norm(np.array([r[0] for r in got]) - np.array([r[0] for r in ref]), axis=1)
    n_pre = [r[2] for r in ref].index(True)
    assert d[:n_pre].max() < 5e-3, d
    assert d.max() < 0.05, d


def test_imu_init_from_reference_state(seq, jax_run):
    _, _, init = jax_run
    fields, windows, order, n_kf, n_lm = init["before"]
    tr = port_tracker(seq)
    tr.state = convert.map_state_from_numpy(fields, "cpu")
    tr.kf_windows = {k: np.asarray(w) for k, w in windows.items()}
    tr.kf_order, tr.n_kf, tr.n_lm = order, n_kf, n_lm
    tr._initialize_imu()
    ref = init["after"]
    got = convert.map_state_to_numpy(tr.state)
    live = np.asarray(order)

    def centres(s):
        return np.einsum("kji,kj->ki", s["kf_R"][live], -s["kf_t"][live])

    np.testing.assert_allclose(centres(got), centres(ref), atol=1e-4)
    np.testing.assert_allclose(got["kf_vel"][live], ref["kf_vel"][live], atol=1e-3)
    for f in ("kf_bg", "kf_ba"):
        np.testing.assert_allclose(got[f][live], ref[f][live], atol=1e-5, err_msg=f)
    lv = ref["lm_valid"].copy()
    lv[0] = False
    np.testing.assert_array_equal(got["lm_valid"], ref["lm_valid"])
    np.testing.assert_allclose(got["lm_pos"][lv], ref["lm_pos"][lv], atol=5e-3)
    assert tr.imu_ready and tr.n_vi_ba == 1


def test_port_inertial_slice_ate(seq, port_run):
    tr, _ = port_run
    assert tr.track_state == ttr.TrackState.OK
    assert tr.imu_ready and tr.n_vi_ba >= 2
    traj = tr.trajectory
    est_pos = np.array([-R.T @ t for _, R, t in traj])
    rmse, _, n = ate.ate_rmse(seq.ts, seq.t_wc, np.array([x[0] for x in traj]), est_pos)
    assert n == N_FRAMES
    assert rmse < 0.03, f"stereo-inertial ATE RMSE {rmse:.4f} m"
    v_est = np.linalg.norm(tr.velocity_log[-1])
    v_gt = np.linalg.norm(seq.vel_gt[-1])
    assert abs(v_est - v_gt) < 0.25 * max(v_gt, 0.2), (v_est, v_gt)
    # a bad-IMU reset drops the map, keeps the trajectory and starts over
    tr._reset_active_map_bad_imu()
    np.testing.assert_allclose(np.array([-R.T @ t for _, R, t in tr.trajectory]), est_pos,
                               atol=1e-9)
    assert tr.track_state == ttr.TrackState.NOT_INITIALIZED and not tr.imu_ready
    tr.process_stereo_inertial(seq.imgs_l[-1], seq.imgs_r[-1], seq.ts[-1] + 0.05,
                               seq.imu[-1])
    assert tr.track_state == ttr.TrackState.OK and tr.kf_order == [0]
    assert len(tr.trajectory) == N_FRAMES + 1


def pack_at_capacity(windows, capacity, count=True):
    """inertial_tracking.pack_imu as it was before the trim: every block
    padded to its capacity."""
    out = np.zeros((len(windows), capacity, 7), np.float32)
    for i, w in enumerate(windows):
        if w is not None:
            w = np.asarray(w, np.float32).reshape(-1, 7)[:capacity]
            out[i, :len(w)] = w
    return out


def test_trimmed_imu_blocks_match_padded(seq, port_traced, monkeypatch):
    """The IMU blocks trimmed to their longest real window change nothing:
    the run with every block padded to its capacity gives byte-equal frame
    poses and keyframe poses, velocities and biases; the trim engaged."""
    _, got, counters, end = port_traced
    assert counters["imu.rows_skipped"] > 0 and counters["imu.rows_integrated"] > 0
    monkeypatch.setattr(tit, "pack_imu", pack_at_capacity)
    ref_tr = port_tracker(seq)
    ref = drive(ref_tr, seq)
    ref_end = run_end(ref_tr)
    assert ref_end["n_vi_ba"] == end["n_vi_ba"] >= 2
    assert all(np.array_equal(a[0], b[0]) and a[1:] == b[1:] for a, b in zip(got, ref))
    for f in KF_STATE:
        assert torch.equal(end[f], ref_end[f]), f
    for (ts, R, t), (ts2, R2, t2) in zip(end["traj"], ref_end["traj"], strict=True):
        assert ts == ts2 and np.array_equal(R, R2) and np.array_equal(t, t2)
