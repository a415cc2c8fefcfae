"""The stereo-inertial tracker with an inertial LoopCloser end to end: port
twins of tests/test_e2e_inertial_loop.py at its 352x240 size, configuration
and bars.

The camera circles a sprite wall with exact 200 Hz IMU samples and 2 gray
levels of image noise; the vocabulary (b10d3) is trained, as the JAX test
trains its own, on descriptors of every (n_frames // 6)-th frame. Bars (the
JAX test's): tracking OK with the IMU initialised, at least one loop
correction, body-frame gravity within 3 degrees (median) and 8 degrees
(max) over the keyframes, keyframe velocities consistent with the corrected
positions (median relative error < 0.35), ATE < 0.25 m.

- `test_inertial_loop_closes_early`: a 52-frame lap and 68 frames (16
  frames of revisit), where the loop closes a few keyframes after the
  revisit starts; about 80 s on one CPU worker.
- `test_inertial_loop_keeps_gravity` (slow, ~100 s): the JAX test's 88
  frames around a 72-frame lap; it does not meet the bars (no correction,
  see its xfail reason).
- `test_jax_inertial_loop_reference_at_full_width` and
  `test_jax_inertial_loop_gravity_across_noise_at_full_width` (slow): where
  chip_smoke.JAX_SI_LOOP_ATE_M, JAX_SI_LOOP_GRAVITY_DEG and
  JAX_SI_LOOP_GRAVITY_SPREAD_DEG come from.

The gravity and velocity checks are chip_smoke.gravity_and_velocity, the
JAX test's arithmetic.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from orb_slam3_vio_fixes_tpu_torch.evaluation import ate
from orb_slam3_vio_fixes_tpu_torch.frontend import inertial_tracking as it
from orb_slam3_vio_fixes_tpu_torch.frontend import loop_closing as lc
from orb_slam3_vio_fixes_tpu_torch.frontend import tracking
from orb_slam3_vio_fixes_tpu_torch.frontend.frame import build_stereo_frame_impl
from orb_slam3_vio_fixes_tpu_torch.imu import preintegration as pre
from orb_slam3_vio_fixes_tpu_torch.io import synthetic
from orb_slam3_vio_fixes_tpu_torch.ops import orb
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms
from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary as voc
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera

torch.set_num_threads(2)


def make_seq(n_frames, n_loop):
    rng = np.random.default_rng(5)
    s = synthetic.make_loop_stereo_inertial_sequence(
        rng, n_frames=n_frames, n_loop=n_loop, h=240, w=352, fx=260.0, baseline=0.2,
        radius=3.0, wall_radius=9.0, n_points=1400)
    noise = rng.normal(0, 2.0, s.imgs_l.shape).astype(np.float32)
    noise_r = rng.normal(0, 2.0, s.imgs_r.shape).astype(np.float32)
    return s._replace(imgs_l=s.imgs_l + noise, imgs_r=s.imgs_r + noise_r)


def run_loop(seq):
    n = seq.imgs_l.shape[0]
    cfg = tracking.TrackerConfig(
        orb=orb.ORBConfig(n_features=384, n_levels=4),
        map=ms.MapConfig(max_keyframes=96, max_landmarks=12288, max_features=384),
        width=352, height=240, max_local_lm=2048, ba_window=6, ba_fixed=2,
        new_lm_budget=256, max_frames_between_kf=4)
    icfg = it.InertialConfig(frame_samples=16, kf_samples=128, init_min_kfs=4,
                             init_min_time=0.5, vi_window=6, max_local_lm=1024,
                             fix_scale=True)
    calib = pre.ImuCalib.make(1.7e-4, 2e-3, 1.9e-5, 3e-3, seq.imu_hz, device="cpu")
    cam = Camera.pinhole(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2])
    bf = seq.K[0, 0] * seq.baseline
    pool = []
    for i in range(0, n, n // 6):
        q = lambda a: torch.as_tensor(np.clip(np.rint(a), 0, 255).astype(np.uint8))  # noqa: E731
        f = build_stereo_frame_impl(q(seq.imgs_l[i]), q(seq.imgs_r[i]), torch.zeros(()), cam,
                                    bf, cfg.orb)
        pool.append(f.desc[f.valid].numpy())
    vocab = voc.train(np.concatenate(pool), branching=10, depth=3, seed=0)
    closer = lc.LoopCloser(
        vocab, cam, cfg.map.max_keyframes, tracking.octave_inv_sigma2(cfg.orb, "cpu"),
        lc.LoopConfig(min_gap_kfs=8, n_consistency=2, fix_scale=True, inertial=True,
                      run_gba=False),
        bf=bf, n_levels=cfg.orb.n_levels, scale=cfg.orb.scale, device="cpu")
    tr = it.StereoInertialTracker(cam, bf, calib, cfg, icfg, device="cpu",
                                  loop_closer=closer)
    tr.match_radius = (15.0, 30.0)
    for i in range(n):
        imu = seq.imu[i - 1] if i > 0 else np.zeros((0, 7), np.float32)
        tr.process_stereo_inertial(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i], imu)
    return tr, closer


def check_bars(seq, tr, closer):
    n = seq.imgs_l.shape[0]
    assert tr.track_state == tracking.TrackState.OK
    assert tr.imu_ready
    assert closer.n_corrections >= 1, f"inertial loop never closed: {closer.hits}"
    order = np.asarray(tr.kf_order)
    errs, v_err = chip_smoke.gravity_and_velocity(
        seq, *(getattr(tr.state, f).numpy()[order] for f in ("kf_R", "kf_t", "kf_ts", "kf_vel")))
    assert np.median(errs) < 3.0, f"gravity misaligned: median {errs} deg"
    assert errs.max() < 8.0, f"gravity misaligned at some keyframe: {errs.max()}"
    assert v_err < 0.35, f"velocities inconsistent with corrected poses: {v_err:.2f}"
    traj = tr.trajectory
    rmse, _, n_m = ate.ate_rmse(seq.ts, seq.t_wc, np.array([x[0] for x in traj]),
                                np.array([-R.T @ t for _, R, t in traj]))
    assert n_m == n
    assert rmse < 0.25, f"stereo-inertial loop ATE {rmse:.3f}"


def test_inertial_loop_closes_early():
    """A 52-frame lap: the revisit starts at frame 52 and the loop closes
    there; the hooks run on the way (place recognition from the IMU
    initialisation on, the 4-DoF correction with its velocity rotation, the
    post-loop full-map VI BA)."""
    seq = make_seq(68, 52)
    tr, closer = run_loop(seq)
    check_bars(seq, tr, closer)
    assert tr.n_vi_ba >= 2


@pytest.mark.slow
@pytest.mark.xfail(strict=True, raises=AssertionError, reason=(
    "measured: all 88 frames tracked, but at 384 features the revisit's "
    "verifications pass the gates only at keyframes 57, 68 and 70, never two "
    "in a row, so no correction is made and the ATE is 0.266 m (bar 0.25 m); "
    "the JAX package's own test of this scene fails at frame 3 on this tree "
    "(ROADMAP queue 3)"))
def test_inertial_loop_keeps_gravity():
    seq = make_seq(88, 72)
    tr, closer = run_loop(seq)
    check_bars(seq, tr, closer)


def _jax_si_loop(s, with_closer: bool):
    """The JAX package's StereoInertialTracker on chip_smoke's stereo-inertial
    loop frames `s` with chip_smoke's configuration, with or without its
    inertial LoopCloser on the 10^5-word vocabulary, on the CPU: ATE,
    (gravity median, max) in degrees, velocity error and corrections."""
    import jax

    from orb_slam3_vio_fixes_tpu.evaluation import ate as jate
    from orb_slam3_vio_fixes_tpu.frontend import inertial_tracking as jit_
    from orb_slam3_vio_fixes_tpu.frontend import loop_closing as jlc
    from orb_slam3_vio_fixes_tpu.frontend import tracking as jtr
    from orb_slam3_vio_fixes_tpu.imu import preintegration as jpre
    from orb_slam3_vio_fixes_tpu.ops import orb as jorb
    from orb_slam3_vio_fixes_tpu.slam_map import map_state as jms
    from orb_slam3_vio_fixes_tpu.slam_map import vocabulary as jvoc
    from orb_slam3_vio_fixes_tpu.utils.cameras import Camera as JCamera

    cfg = jtr.TrackerConfig(orb=jorb.ORBConfig(n_features=1024, n_levels=8),
                            map=jms.MapConfig(256, 32768, 1024), width=752, height=480,
                            max_frames_between_kf=4)
    icfg = jit_.InertialConfig(**chip_smoke.SI_LOOP_ICFG)
    calib = jpre.ImuCalib.make(1.7e-4, 2e-3, 1.9e-5, 3e-3, s.imu_hz)
    cam = JCamera.pinhole(s.K[0, 0], s.K[1, 1], s.K[0, 2], s.K[1, 2])
    bf = s.K[0, 0] * s.baseline
    closer = None
    if with_closer:
        closer = jlc.LoopCloser(jvoc.default_vocabulary(), cam, 256,
                                jtr.octave_inv_sigma2(cfg.orb),
                                jlc.LoopConfig(**chip_smoke.SI_LOOP_LCFG),
                                bf=bf, n_levels=8, scale=1.2)
    tr = jit_.StereoInertialTracker(cam, bf, calib, cfg, icfg, loop_closer=closer)
    tr.match_radius = chip_smoke.SI_LOOP_RADIUS
    for i in range(s.imgs_l.shape[0]):
        imu = s.imu[i - 1] if i > 0 else np.zeros((0, 7), np.float32)
        tr.process_stereo_inertial(s.imgs_l[i], s.imgs_r[i], s.ts[i], imu)
    traj = tr.trajectory
    C = np.array([-R.T @ t for _, R, t in traj])
    order = np.asarray(tr.kf_order)
    errs, v_err = chip_smoke.gravity_and_velocity(
        s, *(np.asarray(getattr(tr.state, f))[order]
             for f in ("kf_R", "kf_t", "kf_ts", "kf_vel")))
    jax.clear_caches()
    return (jate.ate_rmse(s.ts, s.t_wc, np.array([x[0] for x in traj]), C)[0],
            (float(np.median(errs)), float(errs.max())), v_err,
            closer.n_corrections if with_closer else 0)


@pytest.mark.slow
def test_jax_inertial_loop_reference_at_full_width():
    """Where chip_smoke.JAX_SI_LOOP_ATE_M and JAX_SI_LOOP_GRAVITY_DEG come
    from: the JAX package on chip_smoke's stereo-inertial loop scenario (the
    JAX generator, the same seed, noise and configuration), with and without
    the closer. About 8 minutes."""
    from orb_slam3_vio_fixes_tpu.io import synthetic as jsyn

    s = chip_smoke.make_si_loop_sequence(synthetic=jsyn)
    ate_on, gravity, v_err, n_corr = _jax_si_loop(s, True)
    ate_off, _, _, _ = _jax_si_loop(s, False)
    assert n_corr == 2
    assert abs(ate_on - chip_smoke.JAX_SI_LOOP_ATE_M) < 1e-6, ate_on
    np.testing.assert_allclose(gravity, chip_smoke.JAX_SI_LOOP_GRAVITY_DEG, atol=1e-6)
    assert v_err < chip_smoke.VELOCITY_REL_ERR, v_err
    assert abs(ate_off - chip_smoke.JAX_SI_LOOP_OFF_ATE_M) < 1e-6, ate_off


@pytest.mark.slow
@pytest.mark.parametrize("noise_seed", chip_smoke.SI_LOOP_NOISE_SEEDS)
def test_jax_inertial_loop_gravity_across_noise_at_full_width(noise_seed):
    """Where chip_smoke.JAX_SI_LOOP_GRAVITY_SPREAD_DEG comes from: the JAX
    package with the closer on the same scene with other image-noise draws.
    About 4 minutes per seed."""
    from orb_slam3_vio_fixes_tpu.io import synthetic as jsyn

    s = chip_smoke.make_si_loop_sequence(noise_seed=noise_seed, synthetic=jsyn)
    ate_on, gravity, v_err, n_corr = _jax_si_loop(s, True)
    print(f"noise_seed={noise_seed} corrections={n_corr} ate_m={ate_on!r} "
          f"gravity_deg={gravity!r} velocity_rel_err={v_err!r}")
    np.testing.assert_allclose(
        gravity, chip_smoke.JAX_SI_LOOP_GRAVITY_SPREAD_DEG[noise_seed], atol=1e-6)


@pytest.mark.slow
def test_imu_init_from_reference_state_at_full_width():
    """Where the SI loop's gravity offset on the card arises: the JAX
    tracker on chip_smoke's stereo-inertial loop frames at 752x480 (no
    closer: place recognition starts after the IMU initialisation) up to
    its IMU initialisation, and the port's _initialize_imu run from the JAX
    tracker's own pre-init state, as test_torch_inertial_slice.py does at
    352x240. Bar: the body-frame gravity of every live keyframe within 0.1
    degree of the JAX package's, so that any larger offset comes from before
    the initialisation (tracking's float32, the pre-init velocity model).
    About 5 minutes on the CPU."""
    import jax

    from orb_slam3_vio_fixes_tpu.frontend import inertial_tracking as jit_
    from orb_slam3_vio_fixes_tpu.frontend import tracking as jtr
    from orb_slam3_vio_fixes_tpu.imu import preintegration as jpre
    from orb_slam3_vio_fixes_tpu.io import synthetic as jsyn
    from orb_slam3_vio_fixes_tpu.ops import orb as jorb
    from orb_slam3_vio_fixes_tpu.slam_map import map_state as jms
    from orb_slam3_vio_fixes_tpu.utils.cameras import Camera as JCamera
    from orb_slam3_vio_fixes_tpu_torch import convert

    s = chip_smoke.make_si_loop_sequence(synthetic=jsyn)
    cfg = jtr.TrackerConfig(orb=jorb.ORBConfig(n_features=1024, n_levels=8),
                            map=jms.MapConfig(256, 32768, 1024), width=752, height=480,
                            max_frames_between_kf=4)
    icfg = jit_.InertialConfig(**chip_smoke.SI_LOOP_ICFG)
    cam = JCamera.pinhole(s.K[0, 0], s.K[1, 1], s.K[0, 2], s.K[1, 2])
    ref = jit_.StereoInertialTracker(cam, s.K[0, 0] * s.baseline,
                                     jpre.ImuCalib.make(1.7e-4, 2e-3, 1.9e-5, 3e-3, s.imu_hz),
                                     cfg, icfg)
    ref.match_radius = chip_smoke.SI_LOOP_RADIUS
    init = {}
    real = ref._initialize_imu

    def captured():
        init["before"] = ({f: np.array(getattr(ref.state, f), copy=True)
                           for f in jms.MapState._fields},
                          dict(ref.kf_windows), list(ref.kf_order), ref.n_kf, ref.n_lm)
        real()
        init["after"] = {f: np.array(getattr(ref.state, f), copy=True)
                         for f in ("kf_R", "kf_t", "kf_ts", "kf_vel")}

    ref._initialize_imu = captured
    i = 0
    while "after" not in init:
        imu = s.imu[i - 1] if i > 0 else np.zeros((0, 7), np.float32)
        ref.process_stereo_inertial(s.imgs_l[i], s.imgs_r[i], s.ts[i], imu)
        i += 1
        assert i < 40, "the JAX tracker never initialised its IMU"
    jax.clear_caches()

    fields, windows, order, n_kf, n_lm = init["before"]
    tr = chip_smoke.build_si_loop_tracker(s, "cpu")
    tr.state = convert.map_state_from_numpy(fields, "cpu")
    tr.kf_windows = {k: np.asarray(w) for k, w in windows.items()}
    tr.kf_order, tr.n_kf, tr.n_lm = order, n_kf, n_lm
    tr._initialize_imu()
    live = np.asarray(order)
    got = {f: getattr(tr.state, f).numpy()[live] for f in ("kf_R", "kf_t", "kf_ts", "kf_vel")}
    want = {f: a[live] for f, a in init["after"].items()}
    g_got = got["kf_R"] @ np.array([0.0, 0.0, -1.0])
    g_ref = want["kf_R"] @ np.array([0.0, 0.0, -1.0])
    between = np.degrees(np.arccos(np.clip((g_got * g_ref).sum(-1), -1.0, 1.0)))
    err_got, _ = chip_smoke.gravity_and_velocity(s, *(got[f] for f in want))
    err_ref, _ = chip_smoke.gravity_and_velocity(s, *(want[f] for f in want))
    print(f"init at frame {i - 1}: {len(live)} keyframes; port vs JAX body-frame "
          f"gravity max {float(between.max())!r} median {float(np.median(between))!r} "
          f"deg; against the truth median port {float(np.median(err_got))!r} JAX "
          f"{float(np.median(err_ref))!r} deg")
    assert between.max() < 0.1, between


def _gravity_apart_deg(R_a, R_b):
    """Per keyframe, the angle between two maps' body-frame gravity (world
    -Z in the camera frame), degrees, in float64 (arccos of a float32 dot
    product floors at ~0.03 degree)."""
    g = np.array([0.0, 0.0, -1.0])
    a, b = (np.asarray(R, np.float64) @ g for R in (R_a, R_b))
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    return np.degrees(np.arctan2(np.linalg.norm(np.cross(a, b), axis=-1), (a * b).sum(-1)))


def _leaves(nt) -> dict:
    return {f: np.asarray(x) for f, x in nt._asdict().items()}


def _port_window_solve(prob, cfg, K, lm_fixed):
    """The port's solve_vi_ba on a captured JAX window problem with the
    landmark mask `lm_fixed`: (R_wb, p_wb, lm, inlier) as numpy."""
    from orb_slam3_vio_fixes_tpu_torch import convert
    from orb_slam3_vio_fixes_tpu_torch.optim import vi_ba

    p = convert.vi_problem_from_numpy(
        _leaves(prob.states), np.asarray(prob.lm), np.asarray(prob.lm_valid), lm_fixed,
        _leaves(prob.reproj), _leaves(prob.inertial), _leaves(prob.prior),
        Camera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), prob.bf,
        np.asarray(prob.R_cb), np.asarray(prob.t_cb), "cpu")
    out, inlier, _ = vi_ba.solve_vi_ba(p, vi_ba.VIBAConfig(**cfg._asdict()))
    return out.states.R_wb.numpy(), out.states.p_wb.numpy(), out.lm.numpy(), inlier.numpy()


@pytest.fixture(scope="module")
def pre_init_runs():
    """Both StereoInertialTrackers up to the IMU initialisation on
    test_inertial_loop_closes_early's frames, with the JAX initialisation's
    window VI BA problem captured (see test_pre_init_parity_with_reference);
    most of it the JAX tracker's compiles."""
    import jax
    import jax.numpy as jnp

    from orb_slam3_vio_fixes_tpu.frontend import inertial_tracking as jit_
    from orb_slam3_vio_fixes_tpu.frontend import tracking as jtr
    from orb_slam3_vio_fixes_tpu.imu import preintegration as jpre
    from orb_slam3_vio_fixes_tpu.ops import orb as jorb
    from orb_slam3_vio_fixes_tpu.optim import vi_ba as jvi
    from orb_slam3_vio_fixes_tpu.slam_map import map_state as jms
    from orb_slam3_vio_fixes_tpu.utils.cameras import Camera as JCamera

    s = make_seq(68, 52)
    K, bf = s.K, s.K[0, 0] * s.baseline
    jcfg = jtr.TrackerConfig(
        orb=jorb.ORBConfig(n_features=384, n_levels=4),
        map=jms.MapConfig(max_keyframes=96, max_landmarks=12288, max_features=384),
        width=352, height=240, max_local_lm=2048, ba_window=6, ba_fixed=2,
        new_lm_budget=256, max_frames_between_kf=4)
    icfg = dict(frame_samples=16, kf_samples=128, init_min_kfs=4, init_min_time=0.5,
                vi_window=6, max_local_lm=1024, fix_scale=True)
    ref = jit_.StereoInertialTracker(
        JCamera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), bf,
        jpre.ImuCalib.make(1.7e-4, 2e-3, 1.9e-5, 3e-3, s.imu_hz), jcfg,
        jit_.InertialConfig(**icfg))
    tcfg = tracking.TrackerConfig(**{**jcfg._asdict(), "orb": orb.ORBConfig(**jcfg.orb._asdict()),
                                     "map": ms.MapConfig(**jcfg.map._asdict())})
    calib = pre.ImuCalib.make(1.7e-4, 2e-3, 1.9e-5, 3e-3, s.imu_hz, device="cpu")

    def port_tracker():
        return it.StereoInertialTracker(Camera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
                                        bf, calib, tcfg, it.InertialConfig(**icfg),
                                        device="cpu")

    port = port_tracker()
    track = port._track_inertial

    def jax_velocity_model(frame, ts, imu):
        # the JAX tracker's rule: a velocity only from a previous frame that
        # went through the packed path
        prev_packed = port._pose_dev is not None
        out = track(frame, ts, imu)
        if not prev_packed and port._pose_dev is not None:
            port.vel = None
        return out

    port._track_inertial = jax_velocity_model

    def watch(tr, snaps):
        """kf_R before and after each of the initialisation's VI BAs."""
        for name in ("_run_inertial_ba", "_run_full_inertial_ba"):
            real = getattr(tr, name)

            def run(*a, real=real, name=name, **k):
                snaps[name + " before"] = np.array(tr.state.kf_R, copy=True)
                real(*a, **k)
                snaps[name + " after"] = np.array(tr.state.kf_R, copy=True)

            setattr(tr, name, run)

    # the JAX initialisation's window VI BA problem: inertial_local_ba run a
    # second time, unjitted, on copies of its inputs, with solve_vi_ba's
    # problem captured (the tracker keeps the jitted run's result)
    problems = []
    jit_local_ba, jsolve = jit_.inertial_local_ba, jvi.solve_vi_ba

    def capture_problem(*a, **k):
        copies = jax.tree.map(
            lambda x: jnp.array(x, copy=True) if isinstance(x, jax.Array) else x, (a, k))
        out = jit_local_ba(*a, **k)
        jvi.solve_vi_ba = lambda prob, cfg: (problems.append((prob, cfg)), jsolve(prob, cfg))[1]
        try:
            jit_local_ba.__wrapped__(*copies[0], **copies[1])
        finally:
            jvi.solve_vi_ba = jsolve
        return out

    runs = {}
    for name, tr in (("jax", ref), ("port", port)):
        init, vel_none, snaps = {}, [], {}
        real = tr._initialize_imu

        def captured(tr=tr, real=real, init=init, snaps=snaps, name=name):
            init["before"] = ({f: np.array(getattr(tr.state, f), copy=True)
                               for f in ms.MapState._fields}, dict(tr.kf_windows), tr.n_lm)
            watch(tr, snaps)
            if name == "jax":
                jit_.inertial_local_ba = capture_problem
            try:
                real()
            finally:
                jit_.inertial_local_ba = jit_local_ba
            init["after"] = np.array(tr.state.kf_R, copy=True)
            init["lm_after"] = np.array(tr.state.lm_pos[tr.state.lm_valid], copy=True)

        tr._initialize_imu = captured
        i = 0
        while "after" not in init:
            imu = s.imu[i - 1] if i > 0 else np.zeros((0, 7), np.float32)
            tr.process_stereo_inertial(s.imgs_l[i], s.imgs_r[i], s.ts[i], imu)
            vel_none.append(tr.vel is None)
            i += 1
            assert i < 30, f"{name} never initialised its IMU"
        runs[name] = (i - 1, list(tr.kf_order), init, vel_none, snaps)
    return dict(runs=runs, problems=problems, K=K, port_tracker=port_tracker, watch=watch)


def test_pre_init_parity_with_reference(pre_init_runs):
    """Where the SI loop's gravity offset against the JAX package arises:
    both StereoInertialTrackers on test_inertial_loop_closes_early's frames
    (352x240, its configuration with the default search radii, no closer)
    up to the IMU initialisation.

    The JAX tracker's pre-init velocity model comes from the previous
    frame's packed pose only: after a reference-keyframe fallback it has
    none, the next frame's motion model starts from the last pose and falls
    back again, so here it drops the velocity on every second frame. The
    port keeps track_step_impl's own (ROADMAP queue 3, deliberate
    differences); without the JAX rule the pre-init camera centres are 3.8
    cm apart by frame 10 (measured with run_loop's (15, 30) px radii). With the JAX rule put on the port's tracker the two agree: the
    same velocity drops, keyframes and initialisation frame, and pre-init
    keyframe centres within 5e-3 m (test_torch_slice.py's tolerance;
    measured 4.0 mm). From the JAX tracker's own pre-init state, the port's
    initialisation agrees with JAX's within 0.1 degree of body-frame gravity
    up to the gravity alignment (measured 1.4e-5 degree).

    Where they part: the initialisation's window VI BA (its problem captured
    from the JAX tracker's run). Its 24 landmarks seen in the window by one
    keyframe's monocular rows only have a rank-2 3x3 block, whose 1e-6
    damping float32 cannot hold. JAX's LU inverse of some of them is not
    finite, so every LM step is rejected and its BA returns its input (a
    reference fault); the port's adjugate inverse stays finite, its steps
    are accepted and those landmarks leave for ~1e19 m (a port fault). Both
    pinned here, with the parity that holds once those landmarks are held:
    the two solvers within 4.5e-4 degree and 2.9e-6 m, the same inlier
    mask (ROADMAP queue 3). Printed: the gravity apart after each of the
    initialisation's two VI BAs, from the JAX tracker's state and from each
    tracker's own. About 60 s on one CPU worker (the fixture), most of it
    the JAX tracker's compiles. The port's inertial_local_ba holds those
    landmarks (test_init_window_ba_holds_single_view_landmarks); the
    solve_vi_ba runs here take the captured problem as it is."""
    import jax.numpy as jnp

    from orb_slam3_vio_fixes_tpu.optim import vi_ba as jvi
    from orb_slam3_vio_fixes_tpu_torch import convert

    runs, problems, K = (pre_init_runs[k] for k in ("runs", "problems", "K"))
    port_tracker, watch = pre_init_runs["port_tracker"], pre_init_runs["watch"]
    (j_at, j_order, j_init, j_vel, j_snaps), (p_at, p_order, p_init, p_vel, _) = (
        runs["jax"], runs["port"])
    assert sum(j_vel[1:]) >= 3 and j_vel == p_vel
    assert (j_at, j_order) == (p_at, p_order)
    live = np.asarray(j_order)
    fields, windows, n_lm = j_init["before"]
    p_fields = p_init["before"][0]
    gap = np.linalg.norm(
        np.einsum("kji,kj->ki", fields["kf_R"][live], fields["kf_t"][live])
        - np.einsum("kji,kj->ki", p_fields["kf_R"][live], p_fields["kf_t"][live]), axis=1)
    # the port's initialisation from the JAX tracker's pre-init state
    tr = port_tracker()
    tr.state = convert.map_state_from_numpy(fields, "cpu")
    tr.kf_windows = {k: np.asarray(w) for k, w in windows.items()}
    tr.kf_order, tr.n_kf, tr.n_lm = list(j_order), max(j_order) + 1, n_lm
    snaps = {}
    watch(tr, snaps)
    tr._initialize_imu()
    apart = {k: float(_gravity_apart_deg(snaps[k][live], j_snaps[k][live]).max())
             for k in snaps}
    own = _gravity_apart_deg(p_init["after"][live], j_init["after"][live])
    print(f"IMU init at frame {j_at}: pre-init keyframe centres apart max "
          f"{float(gap.max())!r} m; from the JAX pre-init state, gravity apart max (deg) "
          f"{apart}; from each tracker's own state median {float(np.median(own))!r} "
          f"max {float(own.max())!r} deg")
    assert gap.max() < 5e-3, gap
    assert apart["_run_inertial_ba before"] < 0.1, apart

    # the window VI BA on the JAX problem (the first of the initialisation)
    prob, cfg = problems[0]

    def port_solve(lm_fixed):
        return _port_window_solve(prob, cfg, K, lm_fixed)

    j_out, j_inl, _ = jvi.solve_vi_ba(prob, cfg)
    j_R, j_p = np.asarray(j_out.states.R_wb), np.asarray(j_out.states.p_wb)
    # the reference fault: the landmarks whose window observations are one
    # keyframe's monocular rows have a rank-2 3x3 block (the 1e-6 damping
    # is below float32's resolution there); JAX's LU inverse of some is not
    # finite, every LM step is rejected and the BA returns its input
    np.testing.assert_array_equal(j_R, np.asarray(prob.states.R_wb))
    np.testing.assert_array_equal(j_p, np.asarray(prob.states.p_wb))
    # the port's adjugate inverse stays finite: its steps are accepted and
    # those landmarks leave for ~1e19 m (a port fault of its own)
    p_R, p_p, p_lm, _ = port_solve(np.asarray(prob.lm_fixed))
    as_built = float(_gravity_apart_deg(p_R, j_R).max())
    assert as_built > 0.1 and np.abs(p_lm).max() > 1e6, (as_built, np.abs(p_lm).max())
    # with those landmarks held, both solvers agree (measured 4.5e-4 degree,
    # 2.9e-6 m) and JAX's moves the window (0.50 degree)
    rp = prob.reproj
    valid, lm_idx = np.asarray(rp.valid), np.asarray(rp.lm_idx)
    n_lm_win = np.asarray(prob.lm).shape[0]
    seen = np.zeros((n_lm_win, np.asarray(prob.states.R_wb).shape[0]), bool)
    seen[lm_idx[valid], np.asarray(rp.state_idx)[valid]] = True
    stereo = np.bincount(lm_idx[valid & (np.asarray(rp.uvr)[:, 2] >= 0)], minlength=n_lm_win)
    rank2 = (seen.sum(1) == 1) & (stereo == 0)
    held = np.asarray(prob.lm_fixed) | rank2
    j_out, j_inl, _ = jvi.solve_vi_ba(prob._replace(lm_fixed=jnp.asarray(held)), cfg)
    j_R, j_p = np.asarray(j_out.states.R_wb), np.asarray(j_out.states.p_wb)
    p_R, p_p, _, p_inl = port_solve(held)
    moved = float(_gravity_apart_deg(j_R, np.asarray(prob.states.R_wb)).max())
    held_apart = float(_gravity_apart_deg(p_R, j_R).max())
    print(f"init window VI BA: port vs JAX as built {as_built!r} deg; with {int(rank2.sum())} "
          f"rank-2 landmarks held {held_apart!r} deg, positions "
          f"{float(np.abs(p_p - j_p).max())!r} m; JAX's moved {moved!r} deg")
    assert moved > 0.1
    assert held_apart < 0.1 and np.abs(p_p - j_p).max() < 5e-3
    np.testing.assert_array_equal(p_inl, np.asarray(j_inl))


def test_init_window_ba_holds_single_view_landmarks(pre_init_runs):
    """The port's repair of the fault pinned above: the JAX initialisation's
    window VI BA problem through the port's hold rule
    (inertial_tracking.single_view_landmarks, which the stereo-inertial
    initialisation's inertial_local_ba applies on the device) and solved.
    The rule holds exactly the rank-2 landmarks of the test above; every
    landmark stays finite and within 1e3 m; and the solve agrees with JAX's
    on the same problem with the same landmarks held: body-frame gravity
    within 0.1 degree, positions within 5e-3 m, the same inlier mask. The
    port tracker's own initialisation leaves every live landmark within
    1e3 m too."""
    import jax.numpy as jnp

    from orb_slam3_vio_fixes_tpu.optim import vi_ba as jvi
    from orb_slam3_vio_fixes_tpu_torch.optim import vi_ba

    prob, cfg = pre_init_runs["problems"][0]
    K = pre_init_runs["K"]
    rp = _leaves(prob.reproj)
    n_lm, n_states = np.asarray(prob.lm).shape[0], np.asarray(prob.states.R_wb).shape[0]
    reproj = vi_ba.VIReprojFactors(**{f: torch.from_numpy(np.array(a)) for f, a in rp.items()})
    rule = it.single_view_landmarks(reproj, n_lm, n_states).numpy()
    valid, lm_idx = rp["valid"], rp["lm_idx"]
    seen = np.zeros((n_lm, n_states), bool)
    seen[lm_idx[valid], rp["state_idx"][valid]] = True
    stereo = np.bincount(lm_idx[valid & (rp["uvr"][:, 2] >= 0)], minlength=n_lm)
    np.testing.assert_array_equal(rule, (seen.sum(1) == 1) & (stereo == 0))
    held = np.asarray(prob.lm_fixed) | rule
    p_R, p_p, p_lm, p_inl = _port_window_solve(prob, cfg, K, held)
    j_out, j_inl, _ = jvi.solve_vi_ba(prob._replace(lm_fixed=jnp.asarray(held)), cfg)
    j_R, j_p = np.asarray(j_out.states.R_wb), np.asarray(j_out.states.p_wb)
    apart = float(_gravity_apart_deg(p_R, j_R).max())
    print(f"init window VI BA, port's hold rule: {int(rule.sum())} landmarks held, "
          f"|lm| max {float(np.abs(p_lm).max())!r} m, gravity apart from JAX {apart!r} deg, "
          f"positions {float(np.abs(p_p - j_p).max())!r} m")
    assert np.isfinite(p_lm).all() and np.abs(p_lm).max() < 1e3
    assert apart < 0.1 and np.abs(p_p - j_p).max() < 5e-3
    np.testing.assert_array_equal(p_inl, np.asarray(j_inl))
    lm_after = pre_init_runs["runs"]["port"][2]["lm_after"]
    assert np.isfinite(lm_after).all() and np.abs(lm_after).max() < 1e3
