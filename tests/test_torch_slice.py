"""The port's stereo tracker (sync mode) against the JAX package's on the
tests/test_e2e_stereo.py scene and small_cfg (240x352, 400 features, 4
levels), and the port alone over all 30 frames under that test's own bound.

Tolerances: the same keyframe count over the first 12 frames (keyframe
decisions are integer thresholds on counts both sides compute alike);
camera centres within 5 mm over those frames (float32 pose optimisation on
feature sets that differ in a few keypoints, see test_torch_frame); the
port's 30-frame ATE < 0.015 m and scale drift < 2%, test_e2e_stereo's bar.
"""

import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu.frontend import tracking as jtr
from orb_slam3_vio_fixes_tpu.io import synthetic as jsyn
from orb_slam3_vio_fixes_tpu.utils.cameras import Camera as JCamera
from orb_slam3_vio_fixes_tpu_torch.evaluation import ate
from orb_slam3_vio_fixes_tpu_torch.frontend import tracking as ttr
from orb_slam3_vio_fixes_tpu_torch.ops import orb as torb
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as tms
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera as TCamera

from test_e2e_stereo import small_cfg

torch.set_num_threads(2)


N_CMP = 12


@pytest.fixture(scope="module")
def seq():
    rng = np.random.default_rng(7)
    world = jsyn.make_world(rng, n_points=600, extent=7.0, depth_range=(2.5, 9.0))
    return jsyn.make_stereo_sequence(rng, n_frames=30, h=240, w=352, fx=260.0,
                                     baseline=0.2, world=world)


def port_cfg(jcfg) -> ttr.TrackerConfig:
    """The port's TrackerConfig with the same field values."""
    fields = jcfg._asdict()
    fields["orb"] = torb.ORBConfig(**jcfg.orb._asdict())
    fields["map"] = tms.MapConfig(**jcfg.map._asdict())
    return ttr.TrackerConfig(**fields)


def centres(traj):
    return np.array([-R.T @ t for _, R, t in traj])


@pytest.fixture(scope="module")
def runs(seq):
    K = seq.K
    jcfg = small_cfg(seq)
    jt = jtr.StereoTracker(JCamera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
                           K[0, 0] * seq.baseline, jcfg)
    for i in range(N_CMP):
        jt.process_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
    tt = ttr.StereoTracker(TCamera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
                           K[0, 0] * seq.baseline, port_cfg(jcfg), device="cpu")
    head = None
    for i in range(seq.imgs_l.shape[0]):
        tt.process_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
        if i == N_CMP - 1:
            head = (tt.n_kf, len(tt.kf_order), centres(tt.trajectory))
    return jt, tt, head


def test_port_tracks_like_reference(runs):
    jt, _, (n_kf, n_live, port_c) = runs
    assert jt.track_state == jtr.TrackState.OK
    assert (n_kf, n_live) == (jt.n_kf, len(jt.kf_order)) and n_kf >= 2
    ref_c = centres(jt.trajectory)
    assert port_c.shape == ref_c.shape == (N_CMP, 3)
    assert np.abs(port_c - ref_c).max() < 5e-3


def test_port_slice_ate(seq, runs):
    _, tt, _ = runs
    assert tt.track_state == ttr.TrackState.OK
    assert tt.n_kf >= 3
    traj = tt.trajectory
    est_ts = np.array([x[0] for x in traj])
    est_pos = centres(traj)
    rmse, _, n = ate.ate_rmse(seq.ts, seq.t_wc, est_ts, est_pos)
    assert n == len(seq.ts)
    assert rmse < 0.015, f"ATE RMSE {rmse:.4f} m"
    d_est = np.linalg.norm(est_pos[-1] - est_pos[0])
    d_gt = np.linalg.norm(seq.t_wc[-1] - seq.t_wc[0])
    assert abs(d_est / d_gt - 1.0) < 0.02, f"scale drift {d_est / d_gt:.4f}"
