"""The port's RGB-D entries against the JAX package: build_rgbd_frame, the
twin of tests/test_e2e_rgbd.py, and a short IMU_RGBD run through the facade.

Tolerances:
- build_rgbd_frame on the JAX extraction's own features: uv, octave, angle,
  desc and valid exact, ur and depth within 1e-4 (the depth sampling and
  ur = u - bf / z in float32); the extraction runs on a one-image (B = 1)
  atlas; the port's own extraction samples the metric depth map unquantised
  (every depth equals the map's value at the truncated keypoint);
- the e2e twin (24 frames of 352x240 RGB-D): state OK, >= 3 keyframes, ATE
  < 0.08 m (the JAX test's bar) and within 1.5x + 5 mm of the JAX tracker's
  ATE on the same frames;
- IMU_RGBD through SLAMSystem.track_rgbd: state OK and the IMU initialised.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu.evaluation import ate as jate
from orb_slam3_vio_fixes_tpu.frontend import frame as jframe
from orb_slam3_vio_fixes_tpu.frontend import tracking as jtr
from orb_slam3_vio_fixes_tpu.io import synthetic as jsyn
from orb_slam3_vio_fixes_tpu.ops import orb as jorb
from orb_slam3_vio_fixes_tpu.slam_map import map_state as jms
from orb_slam3_vio_fixes_tpu.utils.cameras import Camera as JCamera
from orb_slam3_vio_fixes_tpu_torch import system as sysm
from orb_slam3_vio_fixes_tpu_torch.evaluation import ate
from orb_slam3_vio_fixes_tpu_torch.frontend import frame as tframe
from orb_slam3_vio_fixes_tpu_torch.frontend import tracking as ttr
from orb_slam3_vio_fixes_tpu_torch.io import synthetic as tsyn
from orb_slam3_vio_fixes_tpu_torch.ops import orb as torb
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as tms
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera as TCamera

from test_system import YAML
from test_torch_slice import port_cfg

torch.set_num_threads(2)

N_FRAMES = 24
BF = 260.0 * 0.1


@pytest.fixture(scope="module")
def seq():
    """tests/test_e2e_rgbd.py's sequence (the JAX generator)."""
    rng = np.random.default_rng(11)
    world = jsyn.make_world(rng, n_points=600, extent=7.0, depth_range=(2.5, 9.0))
    return jsyn.make_rgbd_sequence(rng, n_frames=N_FRAMES, h=240, w=352, fx=260.0,
                                   world=world)


def jax_cfg(seq):
    return jtr.TrackerConfig(
        orb=jorb.ORBConfig(n_features=400, n_levels=4),
        map=jms.MapConfig(max_keyframes=32, max_landmarks=4096, max_features=400),
        width=seq.imgs.shape[2], height=seq.imgs.shape[1], max_local_lm=1024,
        ba_window=6, ba_fixed=2, new_lm_budget=256, max_frames_between_kf=6)


def test_build_rgbd_frame_matches_reference(seq, monkeypatch):
    K = seq.K
    img = np.clip(np.rint(seq.imgs[3]), 0, 255).astype(np.uint8)
    depth = seq.depths[3] + np.float32(0.0123)      # fractional metres
    depth[seq.depths[3] <= 0] = -1.0
    cfg = jax_cfg(seq)
    jcam = JCamera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    ref = jframe.build_rgbd_frame(jnp.asarray(img), jnp.asarray(depth), jnp.float32(0.15),
                                  jcam, jnp.float32(BF), cfg.orb)
    jf = jorb.extract(jnp.asarray(img, jnp.float32), cfg.orb)
    seen = []

    def jax_features(imgs, c):
        seen.append(tuple(imgs.shape))
        arrs = [np.array(a) for a in jf]
        return torb.Features(*(torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                                else a)[None] for a in arrs))

    tcam = TCamera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    tcfg = port_cfg(cfg).orb
    with monkeypatch.context() as m:
        m.setattr(torb, "extract_batch", jax_features)
        got = tframe.build_rgbd_frame(torch.from_numpy(img), torch.from_numpy(depth),
                                      torch.tensor(0.15), tcam, BF, tcfg)
    assert seen == [(1, 240, 352)]
    for f in ("uv", "octave", "angle", "desc", "valid"):
        r = np.asarray(getattr(ref, f))
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      r.view(np.int32) if r.dtype == np.uint32 else r,
                                      err_msg=f)
    for f in ("ur", "depth"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   atol=1e-4, err_msg=f)
    assert int((got.depth > 0).sum()) > 100

    # the tracker's own path: K1 on a B = 1 atlas, the host depth unquantised
    tr = ttr.StereoTracker(tcam, BF, port_cfg(cfg), device="cpu")
    fr = tr._build_rgbd(seq.imgs[3], depth, 0.15)
    has = (fr.depth > 0).numpy()
    u = fr.uv.numpy().astype(np.int32)
    np.testing.assert_array_equal(fr.depth.numpy()[has], depth[u[has, 1], u[has, 0]])
    assert np.any(depth[u[has, 1], u[has, 0]] % 1.0 > 0.01)


def _ate(traj, seq):
    C = np.array([-R.T @ t for _, R, t in traj])
    return jate.ate_rmse(seq.ts, seq.t_wc, np.array([x[0] for x in traj]), C)


def test_rgbd_tracking_ate_like_reference(seq):
    K = seq.K
    cfg = jax_cfg(seq)
    jt = jtr.StereoTracker(JCamera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), BF, cfg)
    tt = ttr.StereoTracker(TCamera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), BF,
                           port_cfg(cfg), device="cpu")
    for i in range(N_FRAMES):
        jt.process_rgbd(seq.imgs[i], seq.depths[i], seq.ts[i])
        tt.process_rgbd(seq.imgs[i], seq.depths[i], seq.ts[i])
    ref, _, _ = _ate(jt.trajectory, seq)
    assert tt.track_state == ttr.TrackState.OK
    assert tt.n_kf >= 3
    rmse, _, n = _ate(tt.trajectory, seq)
    assert n == N_FRAMES
    assert rmse < 0.08, f"rgbd ATE {rmse:.3f} m too large"
    assert rmse <= 1.5 * ref + 0.005, (rmse, ref)


IMU_YAML = YAML + """IMU.NoiseGyro: 1.7e-04
IMU.NoiseAcc: 2.0e-03
IMU.GyroWalk: 1.9393e-05
IMU.AccWalk: 3.0e-03
IMU.Frequency: 200.0
"""


def test_imu_rgbd_facade_reaches_imu_init(tmp_path):
    """IMU_RGBD through the facade (the default InertialConfig: the IMU
    initialises after 5 keyframes and 0.95 s) on test_e2e_inertial's scene
    with the left camera's depth maps."""
    rng = np.random.default_rng(5)
    world = tsyn.make_world(rng, n_points=600, extent=7.0, depth_range=(2.5, 9.0))
    s = tsyn.make_stereo_inertial_sequence(rng, n_frames=24, h=240, w=352, fx=260.0,
                                           baseline=0.2, world=world, imu_hz=200.0,
                                           accel_amp=0.6)
    imgs, depths = tsyn.render_depth_along(world, s.K, s.R_wc, s.t_wc, 240, 352)
    path = tmp_path / "imu_rgbd.yaml"
    path.write_text(IMU_YAML)
    slam = sysm.SLAMSystem(
        str(path), sysm.Sensor.IMU_RGBD, vocab=None,
        map_cfg=tms.MapConfig(max_keyframes=32, max_landmarks=4096, max_features=400,
                              n_levels=4), device="cpu")
    assert slam.tracker._local_search_th() == 1.0 and slam.tracker.th_local_base == 1.5
    for i in range(24):
        imu = s.imu[i - 1] if i > 0 else np.zeros((0, 7), np.float32)
        slam.track_rgbd(imgs[i], depths[i], s.ts[i], imu)
    assert slam.get_tracking_state() == ttr.TrackState.OK
    assert slam.tracker.imu_ready
    rmse, _, n = ate.ate_rmse(s.ts, s.t_wc, np.array([x[0] for x in slam.tracker.trajectory]),
                              np.array([-R.T @ t for _, R, t in slam.tracker.trajectory]))
    assert n == 24 and rmse < 0.05, rmse
