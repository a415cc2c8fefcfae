"""The port's loop-closing slice end to end: a port twin of
tests/test_e2e_loop.py::test_loop_closure_improves_exported_ate at its
352x240 size, configuration and bars.

The camera drives 88 frames around a 72-frame lap with 2 gray levels of
sensor noise; the StereoTracker runs once without and once with a
LoopCloser whose b10d3 vocabulary is trained, as the JAX test trains its
own, on descriptors of every 14th frame (here the port's frame build and
the port's k-medians). Bars (the JAX test's): tracking OK, at least one
correction, the best hit at least 2x over every gate, ATE with the closer
below ATE without, revisit gap below 0.8x the gap without.
"""

import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu_torch.evaluation import ate
from orb_slam3_vio_fixes_tpu_torch.frontend import loop_closing as lc
from orb_slam3_vio_fixes_tpu_torch.frontend import tracking
from orb_slam3_vio_fixes_tpu_torch.frontend.frame import build_stereo_frame_impl
from orb_slam3_vio_fixes_tpu_torch.io import synthetic
from orb_slam3_vio_fixes_tpu_torch.ops import orb
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms
from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary as voc
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera

torch.set_num_threads(2)

N_FRAMES = 88
LAP = 72


@pytest.fixture(scope="module")
def seq():
    rng = np.random.default_rng(5)
    s = synthetic.make_loop_stereo_sequence(rng, n_frames=N_FRAMES, h=240, w=352, fx=260.0,
                                            baseline=0.2, radius=3.0, wall_radius=9.0,
                                            n_points=1400, n_loop=LAP)
    noise = rng.normal(0, 2.0, s.imgs_l.shape).astype(np.float32)
    noise_r = rng.normal(0, 2.0, s.imgs_r.shape).astype(np.float32)
    return s._replace(imgs_l=s.imgs_l + noise, imgs_r=s.imgs_r + noise_r)


def _cfg(seq):
    return tracking.TrackerConfig(
        orb=orb.ORBConfig(n_features=384, n_levels=4),
        map=ms.MapConfig(max_keyframes=64, max_landmarks=8192, max_features=384),
        width=seq.imgs_l.shape[2], height=seq.imgs_l.shape[1], max_local_lm=2048,
        ba_window=6, ba_fixed=2, new_lm_budget=256, max_frames_between_kf=4)


def _cam(seq):
    return Camera.pinhole(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2])


def _vocab(seq, cfg):
    pool = []
    for i in range(0, N_FRAMES, N_FRAMES // 6):
        q = lambda a: torch.as_tensor(np.clip(np.rint(a), 0, 255).astype(np.uint8))
        f = build_stereo_frame_impl(q(seq.imgs_l[i]), q(seq.imgs_r[i]), torch.zeros(()),
                                    _cam(seq), seq.K[0, 0] * seq.baseline, cfg.orb)
        pool.append(f.desc[f.valid].numpy())
    return voc.train(np.concatenate(pool), branching=10, depth=3, seed=0, device="cpu")


def _run(seq, cfg, closer):
    tr = tracking.StereoTracker(_cam(seq), seq.K[0, 0] * seq.baseline, cfg, device="cpu",
                                loop_closer=closer)
    for i in range(N_FRAMES):
        tr.process_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
    traj = tr.trajectory
    C = np.array([-R.T @ t for _, R, t in traj])
    rmse, _, n = ate.ate_rmse(seq.ts, seq.t_wc, np.array([x[0] for x in traj]), C)
    assert n == N_FRAMES
    k = np.arange(N_FRAMES - LAP)
    return tr, rmse, float(np.mean(np.linalg.norm(C[k + LAP] - C[k], axis=1)))


def test_loop_closure_improves_exported_ate(seq):
    cfg = _cfg(seq)
    tr_off, ate_off, gap_off = _run(seq, cfg, None)
    assert tr_off.track_state == tracking.TrackState.OK
    lcfg = lc.LoopConfig(min_gap_kfs=8, n_consistency=2, fix_scale=True)
    closer = lc.LoopCloser(_vocab(seq, cfg), _cam(seq), cfg.map.max_keyframes,
                           tracking.octave_inv_sigma2(cfg.orb, "cpu"), lcfg,
                           bf=seq.K[0, 0] * seq.baseline, n_levels=cfg.orb.n_levels,
                           scale=cfg.orb.scale, device="cpu")
    tr_on, ate_on, gap_on = _run(seq, cfg, closer)
    assert tr_on.track_state == tracking.TrackState.OK
    assert closer.n_corrections >= 1, "loop never closed on a circular revisit"
    best = max(closer.hits, key=lambda h: h["n_m"])
    assert best["n_m"] >= 2 * lcfg.min_bow_matches, closer.hits
    assert best["n_ransac"] >= 2 * lcfg.min_sim3_inliers, closer.hits
    assert best["n_proj"] >= 2 * lcfg.min_proj_matches, closer.hits
    assert ate_on < ate_off, f"ATE {ate_off:.4f} -> {ate_on:.4f}"
    assert gap_on < 0.8 * gap_off, f"revisit gap {gap_off:.4f} -> {gap_on:.4f}"


@pytest.mark.slow
def test_jax_loop_reference_at_full_width():
    """Where chip_smoke.JAX_LOOP_ATE_M comes from: the JAX package's
    StereoTracker, with and without its LoopCloser on the 10^5-word
    vocabulary, on chip_smoke's loop scenario (the JAX generator, the same
    seed, noise and configuration), on the CPU. About 7 minutes and 3 GB."""
    import jax

    from orb_slam3_vio_fixes_tpu.evaluation import ate as jate
    from orb_slam3_vio_fixes_tpu.frontend import loop_closing as jlc
    from orb_slam3_vio_fixes_tpu.frontend import tracking as jtr
    from orb_slam3_vio_fixes_tpu.io import synthetic as jsyn
    from orb_slam3_vio_fixes_tpu.ops import orb as jorb
    from orb_slam3_vio_fixes_tpu.slam_map import map_state as jms
    from orb_slam3_vio_fixes_tpu.slam_map import vocabulary as jvoc
    from orb_slam3_vio_fixes_tpu.utils.cameras import Camera as JCamera

    import chip_smoke

    n, lap = chip_smoke.LOOP_FRAMES, chip_smoke.LOOP_LAP
    rng = np.random.default_rng(5)
    s = jsyn.make_loop_stereo_sequence(rng, n_frames=n, h=480, w=752, fx=458.0,
                                       baseline=0.11, radius=3.0, wall_radius=9.0,
                                       n_points=1400, n_loop=lap)
    noise = rng.normal(0, 2.0, s.imgs_l.shape).astype(np.float32)
    noise_r = rng.normal(0, 2.0, s.imgs_r.shape).astype(np.float32)
    s = s._replace(imgs_l=s.imgs_l + noise, imgs_r=s.imgs_r + noise_r)
    cfg = jtr.TrackerConfig(orb=jorb.ORBConfig(n_features=1024, n_levels=8),
                            map=jms.MapConfig(256, 32768, 1024), width=752, height=480,
                            max_frames_between_kf=4)
    cam = JCamera.pinhole(s.K[0, 0], s.K[1, 1], s.K[0, 2], s.K[1, 2])
    bf = s.K[0, 0] * s.baseline

    def run(closer):
        tr = jtr.StereoTracker(cam, bf, cfg, loop_closer=closer)
        for i in range(n):
            tr.process_stereo(s.imgs_l[i], s.imgs_r[i], s.ts[i])
        traj = tr.trajectory
        C = np.array([-R.T @ t for _, R, t in traj])
        k = np.arange(n - lap)
        return (jate.ate_rmse(s.ts, s.t_wc, np.array([x[0] for x in traj]), C)[0],
                float(np.mean(np.linalg.norm(C[k + lap] - C[k], axis=1))))

    closer = jlc.LoopCloser(jvoc.default_vocabulary(), cam, 256,
                            jtr.octave_inv_sigma2(cfg.orb),
                            jlc.LoopConfig(min_gap_kfs=8, n_consistency=2, fix_scale=True),
                            bf=bf, n_levels=8, scale=1.2)
    ate_on, gap_on = run(closer)
    jax.clear_caches()
    ate_off, gap_off = run(None)
    jax.clear_caches()
    assert closer.n_corrections == 2
    assert abs(ate_on - chip_smoke.JAX_LOOP_ATE_M) < 1e-6, ate_on
    assert ate_off > 0.15 and gap_on < 0.8 * gap_off, (ate_off, gap_on, gap_off)
