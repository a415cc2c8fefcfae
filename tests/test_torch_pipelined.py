"""The port's pipelined tracking and asynchronous keyframe jobs: twins of
tests/test_pipelined.py on the same 20 frames at 352x240, and the port's
own guards.

Bars: pipelined equals sync bit for bit (trajectory, keyframe order,
landmark count); async keyframe jobs within test_pipelined.py's bars (same
keyframe order, landmark count within 10%, camera centres within 0.01 m
median and 0.05 m max of the sync run); the pipelined return value is the
previous frame's pose; the port's pipelined and async centres within 5 mm
of the JAX package's pipelined and async runs, with the same keyframe
order (test_torch_slice.py's tolerance). A speculative
step is kept only when the map it read has had no in-place write since:
the object identities alone (the reference's id() key) would keep it.
"""

import types

import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu.frontend import tracking as jtr
from orb_slam3_vio_fixes_tpu.io import synthetic as jsyn
from orb_slam3_vio_fixes_tpu.utils.cameras import Camera as JCamera
from orb_slam3_vio_fixes_tpu_torch import system as sysm
from orb_slam3_vio_fixes_tpu_torch.evaluation import ate
from orb_slam3_vio_fixes_tpu_torch.frontend import inertial_tracking as it
from orb_slam3_vio_fixes_tpu_torch.frontend import loop_closing as lc
from orb_slam3_vio_fixes_tpu_torch.frontend import tracking as ttr
from orb_slam3_vio_fixes_tpu_torch.imu import preintegration as pre
from orb_slam3_vio_fixes_tpu_torch.io import synthetic
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera as TCamera

import test_torch_loop_slice as loop_slice
from test_pipelined import _cfg as jax_cfg
from test_system import YAML
from test_torch_slice import port_cfg

torch.set_num_threads(2)

N_FRAMES = 20


@pytest.fixture(scope="module")
def seq():
    rng = np.random.default_rng(7)
    world = jsyn.make_world(rng, n_points=600, extent=7.0, depth_range=(2.5, 9.0))
    return jsyn.make_stereo_sequence(rng, n_frames=N_FRAMES, h=240, w=352, fx=260.0,
                                     baseline=0.2, world=world)


def tracker(seq, pipelined=False, async_kf=False, **kw):
    K = seq.K
    tr = ttr.StereoTracker(TCamera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
                           K[0, 0] * seq.baseline, port_cfg(jax_cfg(seq)), device="cpu",
                           **kw)
    tr.pipelined = pipelined
    tr.async_kf = async_kf
    return tr


def run(seq, **modes):
    tr = tracker(seq, **modes)
    returned = [tr.process_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
                for i in range(N_FRAMES)]
    tr.flush()
    return tr, returned


def centres(traj):
    return np.array([-R.T @ t for _, R, t in traj])


@pytest.fixture(scope="module")
def runs(seq):
    return {name: run(seq, **modes) for name, modes in (
        ("sync", {}), ("pipelined", dict(pipelined=True)),
        ("async", dict(pipelined=True, async_kf=True)))}


def test_pipelined_matches_sync(runs):
    (sync, _), (pipe, _) = runs["sync"], runs["pipelined"]
    assert pipe.track_state == sync.track_state == ttr.TrackState.OK
    assert pipe.kf_order == sync.kf_order and len(sync.kf_order) >= 3
    assert pipe.n_lm == sync.n_lm
    traj_s, traj_p = sync.trajectory, pipe.trajectory
    assert len(traj_p) == len(traj_s) == N_FRAMES
    for (ts_s, R_s, t_s), (ts_p, R_p, t_p) in zip(traj_s, traj_p):
        assert ts_s == ts_p
        np.testing.assert_array_equal(R_p, R_s)
        np.testing.assert_array_equal(t_p, t_s)
    # the keyframe inserts invalidate their next frame's speculation
    assert 0 < pipe.spec_reused < pipe.spec_dispatched


def test_async_kf_matches_sync_quality(runs):
    (sync, _), (asy, _) = runs["sync"], runs["async"]
    assert asy.track_state == sync.track_state
    assert asy.kf_order == sync.kf_order
    assert abs(asy.n_lm - sync.n_lm) <= 0.1 * sync.n_lm
    assert not asy._kf_jobs
    errs = np.linalg.norm(centres(asy.trajectory) - centres(sync.trajectory), axis=1)
    assert len(errs) == N_FRAMES
    assert np.median(errs) < 0.01 and errs.max() < 0.05, errs


def test_pipelined_return_lags_one_frame(runs):
    pipe, returned = runs["pipelined"]
    traj = pipe.trajectory
    # call i (i >= 2, steady state) returned frame i - 1's pose; checked
    # before the first keyframe after KF0, whose local BA moves the poses the
    # trajectory exports through
    for i in range(2, 6):
        np.testing.assert_allclose(returned[i][1], traj[i - 1][2], atol=1e-6)
        np.testing.assert_allclose(returned[i][0], traj[i - 1][1], atol=1e-6)


def jax_run(seq, async_kf=False):
    K = seq.K
    jt = jtr.StereoTracker(JCamera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
                           K[0, 0] * seq.baseline, jax_cfg(seq))
    jt.pipelined = True
    jt.async_kf = async_kf
    for i in range(N_FRAMES):
        jt.process_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
    jt.flush()
    return jt


def test_pipelined_like_reference(seq, runs):
    jt = jax_run(seq)
    pipe, _ = runs["pipelined"]
    assert pipe.kf_order == jt.kf_order
    ref, got = centres(jt.trajectory), centres(pipe.trajectory)
    assert got.shape == ref.shape == (N_FRAMES, 3)
    assert np.abs(got - ref).max() < 5e-3


def test_async_like_reference(seq, runs):
    """The port's asynchronous keyframe jobs against the JAX package's on
    the same frames: the same keyframe order, centres within 5 mm."""
    jt = jax_run(seq, async_kf=True)
    asy, _ = runs["async"]
    assert not jt._kf_jobs and not asy._kf_jobs
    assert asy.kf_order == jt.kf_order
    ref, got = centres(jt.trajectory), centres(asy.trajectory)
    assert got.shape == ref.shape == (N_FRAMES, 3)
    assert np.abs(got - ref).max() < 5e-3


def test_speculation_keyed_on_map_writes(seq):
    """Frame 5's speculative step is kept; frame 6's is dropped after an
    in-place write to the map while frame 5 was finalised, although every
    object the step read is the same one."""
    tr = tracker(seq, pipelined=True)
    for i in range(5):
        tr.process_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
    inputs = []
    dispatch, finalize = tr._dispatch_track, tr._finalize_track

    def dispatch_logged(*a, **k):
        out = dispatch(*a, **k)
        inputs.append(out[0])
        return out

    write = [False]

    def finalize_then_write(*a, **k):
        out = finalize(*a, **k)
        if write[0]:
            tr.state.lm_pos.add_(torch.tensor([0.0, 0.0, 0.01]))
        return out

    tr._dispatch_track = dispatch_logged
    tr._finalize_track = finalize_then_write
    reused = tr.spec_reused
    tr.process_stereo(seq.imgs_l[5], seq.imgs_r[5], seq.ts[5])
    assert tr.spec_reused == reused + 1 and len(inputs) == 1
    write[0] = True
    tr.process_stereo(seq.imgs_l[6], seq.imgs_r[6], seq.ts[6])
    assert tr.spec_reused == reused + 1, "a step that read a rewritten map was kept"
    spec, actual = inputs[1:]
    assert all(a is b for a, b in zip(spec.objs, actual.objs))
    assert spec.scalars == actual.scalars and spec.versions != actual.versions
    assert not spec.same(actual)


def test_resets_empty_kf_jobs(seq, tmp_path):
    """SLAMSystem.reset_active_map and the bad-IMU reset drop the pending
    keyframe jobs; the jobs name slots of the dropped map."""
    path = tmp_path / "stereo.yaml"
    path.write_text(YAML)
    slam = sysm.SLAMSystem(str(path), sysm.Sensor.STEREO, vocab=None,
                           map_cfg=port_cfg(jax_cfg(seq)).map,
                           tracker_cfg=port_cfg(jax_cfg(seq)), device="cpu")
    tr = slam.tracker
    tr.pipelined = tr.async_kf = True
    i = 0
    while not tr._kf_jobs:
        slam.track_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
        i += 1
    slam.reset_active_map()
    assert not tr._kf_jobs and tr._pending is None and tr.n_kf == 0
    assert tr.track_state == ttr.TrackState.NOT_INITIALIZED
    K = seq.K
    calib = pre.ImuCalib.make(1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0, device="cpu")
    vi = it.StereoInertialTracker(TCamera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
                                  K[0, 0] * seq.baseline, calib, port_cfg(jax_cfg(seq)),
                                  device="cpu")
    ran = []
    vi._kf_jobs.append(lambda: ran.append(1))
    vi._reset_active_map_bad_imu()
    assert not vi._kf_jobs and not ran


def test_spawn_new_map_drains_before_stash(seq):
    """A stash takes the map with every pending keyframe job applied."""
    stashed = []
    atlas = types.SimpleNamespace(
        stored=[], map_cfg=None,
        stash_active=lambda state, n_kf, n_lm, hists: stashed.append(n_kf))
    tr = tracker(seq, pipelined=True, async_kf=True, atlas=atlas)
    i = 0
    while not tr._kf_jobs:
        tr.process_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
        i += 1
    tr.flush(drain_jobs=False)
    ran = []
    tr._kf_jobs.append(lambda: ran.append(len(stashed)))
    tr._spawn_new_map()
    assert ran == [0] and stashed and not tr._kf_jobs


@pytest.mark.slow
def test_loop_closure_pipelined_async(monkeypatch):
    """The twin of tests/test_e2e_loop.py::test_loop_closure_pipelined_async
    on the port: test_torch_loop_slice.py's revisit (88 frames, 352x240)
    with pipelined tracking and asynchronous keyframe jobs, without and with
    the closer. A correction fires inside a job, its world delta is
    published for the poses in flight (`_corr_delta`), tracking stays OK,
    the exported ATE improves and the revisit gap closes below 0.8x
    (the JAX test's bars). Against the sync run this scene does not meet the
    async bars of test_async_kf_matches_sync_quality in either package:
    over its first 76 frames with the closer the async centres sit 0.032 m
    (JAX) and 0.051 m (the port) from their sync runs' at the median, with
    74 / 76 keyframes against 65 / 63. About 2.5 minutes."""
    rng = np.random.default_rng(5)
    s = synthetic.make_loop_stereo_sequence(
        rng, n_frames=loop_slice.N_FRAMES, h=240, w=352, fx=260.0, baseline=0.2,
        radius=3.0, wall_radius=9.0, n_points=1400, n_loop=loop_slice.LAP)
    s = s._replace(imgs_l=s.imgs_l + rng.normal(0, 2.0, s.imgs_l.shape).astype(np.float32),
                   imgs_r=s.imgs_r + rng.normal(0, 2.0, s.imgs_r.shape).astype(np.float32))
    cfg = loop_slice._cfg(s)
    published = []
    stage_loop = ttr.StereoTracker._kf_stage_loop

    def loop_logged(self, kf_id):
        epoch = self._corr_epoch
        stage_loop(self, kf_id)
        if self._corr_epoch != epoch:
            published.append(self._corr_delta is not None)

    monkeypatch.setattr(ttr.StereoTracker, "_kf_stage_loop", loop_logged)

    def run_async(closer):
        tr = ttr.StereoTracker(loop_slice._cam(s), s.K[0, 0] * s.baseline, cfg,
                               device="cpu", loop_closer=closer)
        tr.pipelined = tr.async_kf = True
        for i in range(loop_slice.N_FRAMES):
            tr.process_stereo(s.imgs_l[i], s.imgs_r[i], s.ts[i])
        tr.flush()
        assert tr.track_state == ttr.TrackState.OK
        C = centres(tr.trajectory)
        rmse, _, n = ate.ate_rmse(s.ts, s.t_wc, s.ts, C)
        assert n == loop_slice.N_FRAMES
        k = np.arange(loop_slice.N_FRAMES - loop_slice.LAP)
        return rmse, float(np.mean(np.linalg.norm(C[k + loop_slice.LAP] - C[k], axis=1)))

    ate_off, gap_off = run_async(None)
    closer = lc.LoopCloser(loop_slice._vocab(s, cfg), loop_slice._cam(s),
                           cfg.map.max_keyframes, ttr.octave_inv_sigma2(cfg.orb, "cpu"),
                           lc.LoopConfig(min_gap_kfs=8, n_consistency=2, fix_scale=True),
                           bf=s.K[0, 0] * s.baseline, n_levels=cfg.orb.n_levels,
                           scale=cfg.orb.scale, device="cpu")
    ate_on, gap_on = run_async(closer)
    assert closer.n_corrections >= 1, "loop never closed in async mode"
    assert published and all(published)
    assert ate_on < ate_off, f"ATE {ate_off:.4f} -> {ate_on:.4f}"
    assert gap_on < 0.8 * gap_off, f"revisit gap {gap_off:.4f} -> {gap_on:.4f}"
