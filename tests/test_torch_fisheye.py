"""The port's KannalaBrandt8 two-camera stereo: twins of
tests/test_fisheye_stereo.py, the frame build against the JAX package's on
the same images, and the facade's rig from configs/TUM-VI.yaml.

Tolerances: the test_fisheye_stereo.py bars (exact geometry: median relative
depth error < 0.5%, max < 5%; rendered pair: >= 60 depths, median relative
error against the z-buffer < 0.15, > 80% within 30%; no depth without
parallax). Against the JAX frame build, keypoints are matched by (octave,
u, v) as in test_torch_frame.py (the two extractions agree on >= 98% of
them): the rows with a depth agree on >= 98% of the keypoints either side
triangulates, and their depths agree within 1e-3 relative on >= 98%.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from orb_slam3_vio_fixes_tpu.frontend import frame as jframe
from orb_slam3_vio_fixes_tpu.io import synthetic as jsyn
from orb_slam3_vio_fixes_tpu.ops import orb as jorb
from orb_slam3_vio_fixes_tpu.utils.cameras import Camera as JCamera
from orb_slam3_vio_fixes_tpu_torch import system as sysm
from orb_slam3_vio_fixes_tpu_torch.frontend import frame as tframe
from orb_slam3_vio_fixes_tpu_torch.frontend import tracking as ttr
from orb_slam3_vio_fixes_tpu_torch.frontend.inertial_tracking import StereoInertialTracker
from orb_slam3_vio_fixes_tpu_torch.io import settings as tset
from orb_slam3_vio_fixes_tpu_torch.ops import orb as torb
from orb_slam3_vio_fixes_tpu_torch.ops import triangulate as tri
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import KB8
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera as TCamera
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import project, unproject

from test_fisheye_stereo import BASELINE, CX, CY, DIST, FX, FY, H, W
from test_torch_frame import _keys

torch.set_num_threads(2)

CFG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs")


def _cams():
    cam = TCamera.kb8(FX, FY, CX, CY, *DIST)
    return cam, cam


def _render_pair(rng):
    """test_fisheye_stereo._render_pair with the port's KB8 projection."""
    cam1, cam2 = _cams()
    world = jsyn.make_world(rng, n_points=500, extent=4.0, depth_range=(2.0, 7.0))
    K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)

    def proj(cam):
        return lambda Xc: project(cam, torch.as_tensor(Xc, dtype=torch.float32)).numpy()

    R = np.eye(3, dtype=np.float32)
    img_l, z_l = jsyn.render(world, K, R, np.zeros(3, np.float32), H, W,
                             return_depth=True, project_fn=proj(cam1))
    img_r = jsyn.render(world, K, R, np.array([-BASELINE, 0, 0], np.float32), H, W,
                        project_fn=proj(cam2))
    return cam1, cam2, img_l, img_r, z_l


def _rig():
    return torch.eye(3), torch.tensor([BASELINE, 0.0, 0.0])


def _build(img_l, img_r, R_12, t_12):
    cam1, cam2 = _cams()
    return tframe.build_fisheye_stereo_frame(
        torch.as_tensor(img_l), torch.as_tensor(img_r), torch.tensor(0.0), cam1, cam2,
        R_12, t_12, torb.ORBConfig(n_features=400, n_levels=4))


def test_fisheye_exact_geometry():
    cam1, cam2 = _cams()
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(-3, 3, 200), rng.uniform(-2, 2, 200),
                  rng.uniform(2, 7, 200)], 1).astype(np.float32)
    Xt = torch.as_tensor(X)
    ray1 = unproject(cam1, project(cam1, Xt))
    ray2 = unproject(cam2, project(cam2, Xt - torch.tensor([BASELINE, 0.0, 0.0])))
    n = X.shape[0]
    eye = torch.eye(3).expand(n, 3, 3)
    t21 = torch.tensor([-BASELINE, 0.0, 0.0]).expand(n, 3)
    got = tri.triangulate_midpoint(eye, torch.zeros(n, 3), eye, t21, ray1, ray2)
    rel = np.abs(got[:, 2].numpy() - X[:, 2]) / X[:, 2]
    assert np.median(rel) < 0.005 and rel.max() < 0.05, (np.median(rel), rel.max())


def test_fisheye_stereo_depth_recovery():
    _, _, img_l, img_r, z_l = _render_pair(np.random.default_rng(3))
    frame = _build(img_l, img_r, *_rig())
    depth, uv, valid = frame.depth.numpy(), frame.uv.numpy(), frame.valid.numpy()
    assert (frame.ur == -1).all()
    has_d = valid & (depth > 0)
    assert has_d.sum() >= 60, f"too few triangulated: {has_d.sum()}"
    xi = np.clip(np.round(uv[:, 0]).astype(int), 0, W - 1)
    yi = np.clip(np.round(uv[:, 1]).astype(int), 0, H - 1)
    z_gt = z_l[yi, xi]
    ok = has_d & (z_gt > 0)
    rel = np.abs(depth[ok] - z_gt[ok]) / z_gt[ok]
    assert np.median(rel) < 0.15, f"median depth err {np.median(rel):.4f}"
    assert (rel < 0.3).mean() > 0.8, f"only {(rel < 0.3).mean():.2f} within 30%"


def test_fisheye_frame_matches_reference():
    _, _, img_l, img_r, _ = _render_pair(np.random.default_rng(3))
    tfr = _build(img_l, img_r, *_rig())
    jcam = JCamera.kb8(FX, FY, CX, CY, *DIST)
    jfr = jframe.build_fisheye_stereo_frame(
        jnp.asarray(img_l), jnp.asarray(img_r), jnp.float32(0.0), jcam, jcam, jnp.eye(3),
        jnp.asarray([BASELINE, 0.0, 0.0], jnp.float32),
        jorb.ORBConfig(n_features=400, n_levels=4))
    jk = _keys(np.asarray(jfr.uv), np.asarray(jfr.octave), np.asarray(jfr.valid))
    tk = _keys(tfr.uv.numpy(), tfr.octave.numpy(), tfr.valid.numpy())
    common = sorted(jk.keys() & tk.keys())
    assert len(common) >= 0.98 * len(jk.keys() | tk.keys())
    ji = np.array([jk[k] for k in common])
    ti = np.array([tk[k] for k in common])
    jz, tz = np.asarray(jfr.depth)[ji], tfr.depth.numpy()[ti]
    both, either = (jz > 0) & (tz > 0), (jz > 0) | (tz > 0)
    assert both.sum() >= 60 and both.sum() >= 0.98 * either.sum(), (both.sum(), either.sum())
    close = np.abs(jz - tz) <= 1e-3 * np.abs(jz)
    assert close[both].mean() >= 0.98, close[both].mean()


def test_system_wires_kb8_rig():
    """SLAMSystem from the TUM-VI calibration hands the tracker both KB8
    cameras and T_c1_c2 with bf = |t| * fx, and tracks the fisheye images
    unrectified (no remaps)."""
    path = os.path.join(CFG_DIR, "TUM-VI.yaml")
    for sensor, kind in ((sysm.Sensor.IMU_STEREO, StereoInertialTracker),
                         (sysm.Sensor.STEREO, ttr.StereoTracker)):
        st = tset.load_settings(path, sensor)
        assert not st.needs_rectification
        slam = sysm.SLAMSystem(st, sensor, vocab=None, device="cpu")
        assert type(slam.tracker) is kind and slam._rect_maps is None
        assert slam.settings.rect is None and slam._undist_map is None
        cam2, R_12, t_12 = slam.tracker.rig
        assert abs(float(torch.linalg.norm(t_12)) - 0.1011) < 1e-3
        assert 15.0 < float(slam.tracker.bf) < 25.0
        assert cam2.kind == KB8 and slam.tracker.cam.kind == KB8
        assert abs(slam.tracker.bf - float(torch.linalg.norm(t_12)) * st.cam1.fx) < 1e-3


def test_fisheye_rejects_without_parallax():
    _, _, img_l, _, _ = _render_pair(np.random.default_rng(4))
    frame = _build(img_l, img_l, torch.eye(3), torch.zeros(3))
    assert (frame.depth > 0).sum() == 0


@pytest.mark.slow
@pytest.mark.parametrize("mode", chip_smoke.FISHEYE_MODES)
def test_jax_fisheye_reference_at_full_width(mode):
    """Where chip_smoke.JAX_FISHEYE_ATE_M comes from: the JAX package's
    SLAMSystem (its default vocabulary) from configs/TUM-VI.yaml on
    chip_smoke's fisheye frames, on the CPU, scored by
    chip_smoke.trajectory_ate. Two to four minutes per mode."""
    import jax

    from orb_slam3_vio_fixes_tpu import system as jsys

    frames, ts, t_wc, _ = chip_smoke.fisheye_scenario()
    slam = jsys.SLAMSystem(os.path.join(CFG_DIR, "TUM-VI.yaml"), getattr(jsys.Sensor, mode))
    assert slam.tracker.rig is not None
    states = []
    for a, b, t, imu in frames:
        slam.track_stereo(a, b, t, imu)
        states.append(slam.get_tracking_state())
    tr = slam.tracker
    rmse = chip_smoke.trajectory_ate(ts, t_wc, tr, len(frames))
    jax.clear_caches()
    print(f"jax fisheye {mode} at 512x512: states={states} keyframes={len(tr.kf_order)} "
          f"imu_ready={getattr(tr, 'imu_ready', None)} ate_m={rmse!r}")
    assert slam.get_tracking_state() == "OK"
    assert abs(rmse - chip_smoke.JAX_FISHEYE_ATE_M[mode]) < 1e-6, rmse
