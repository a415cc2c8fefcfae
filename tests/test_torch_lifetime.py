"""The map's lifetime on the port (orb_slam3_vio_fixes_tpu_torch/lifetime.py):
the twins of tests/test_kf_culling.py, test_slot_reuse.py and
test_retrieval_pr.py, with those tests' own sizes and bars, and the scene of
tests/test_marathon.py, which runs on the card only (chip_smoke.py phase 21).

Tier 1: the twin of `test_capacity_growth`, a short culling run in which
keyframes land in freed slots, held frame by frame against the JAX tracker
on the same frames (the same slot counter `_kf_created_reused`, high-water
`n_kf`, live keyframe order and free list), and the marathon's pre-rendered
frames against the generator's own scene. The JAX package's slow tests have
slow twins here; the culling and slot-reuse twins also hold the port's
created, live and tier counts equal to the JAX tracker's on the same run.
"""

import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu.frontend import tracking as jtr
from orb_slam3_vio_fixes_tpu.io import synthetic as jsyn
from orb_slam3_vio_fixes_tpu.ops import orb as jorb
from orb_slam3_vio_fixes_tpu.slam_map import map_state as jms
from orb_slam3_vio_fixes_tpu.utils.cameras import Camera as JCamera
from orb_slam3_vio_fixes_tpu_torch import lifetime
from orb_slam3_vio_fixes_tpu_torch.frontend import tracking
from orb_slam3_vio_fixes_tpu_torch.io import synthetic as tsyn
from orb_slam3_vio_fixes_tpu_torch.ops import orb
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera

torch.set_num_threads(2)


def _ok(out):
    assert not out["failed"], out


def test_capacity_growth():
    out = lifetime.capacity_growth_run("cpu")
    _ok(out)
    assert out["n_kf"] > 8 and out["max_keyframes"] >= 16


def jax_cfg(cfg: tracking.TrackerConfig) -> jtr.TrackerConfig:
    """The JAX package's TrackerConfig with the same field values."""
    fields = cfg._asdict()
    fields["orb"] = jorb.ORBConfig(**cfg.orb._asdict())
    fields["map"] = jms.MapConfig(**cfg.map._asdict())
    return jtr.TrackerConfig(**fields)


def trackers(seq, cfg):
    """(JAX tracker, port tracker on the CPU) for seq under cfg."""
    K = seq.K
    jt = jtr.StereoTracker(JCamera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
                           K[0, 0] * seq.baseline, jax_cfg(cfg))
    tt = tracking.StereoTracker(Camera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
                                K[0, 0] * seq.baseline, cfg, device="cpu")
    return jt, tt


def slots(tr):
    """A tracker's keyframe-slot bookkeeping: (n_kf, keyframes landed in
    reused slots, live keyframes in order, free slots, state)."""
    return (tr.n_kf, tr._kf_created_reused, list(tr.kf_order), list(tr._free_kf_slots),
            str(tr.track_state))


def test_culled_slots_are_reused():
    """12 frames of test_slot_reuse's slow orbit with a keyframe and a
    culling pass every frame: keyframes land in culled slots, with the same
    slot choice, counter, culling order and free list as the JAX tracker
    after every frame (exact: integer bookkeeping), and the live
    bookkeeping stays consistent."""
    rng = np.random.default_rng(3)
    world = tsyn.make_world(rng, n_points=900, extent=9.0, depth_range=(2.5, 9.0))
    seq = tsyn.make_stereo_sequence(rng, n_frames=12, h=240, w=352, fx=260.0, baseline=0.2,
                                    speed=(0.25, 0.0, 0.04), yaw_rate=0.02, world=world)
    cfg = tracking.TrackerConfig(
        orb=orb.ORBConfig(n_features=400, n_levels=4),
        map=ms.MapConfig(max_keyframes=32, max_landmarks=4096, max_features=400),
        width=352, height=240, max_local_lm=1024, ba_window=6, ba_fixed=2,
        new_lm_budget=256, max_frames_between_kf=1, kf_cull_every=1, kf_cull_max=4)
    jt, tr = trackers(seq, cfg)
    assert tr._kf_created_reused == 0
    inserted = 0
    for i in range(12):
        before = (tr.n_kf, tr._kf_created_reused, list(tr._free_kf_slots))
        jt.process_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
        tr.process_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
        assert slots(tr) == slots(jt), i
        if tr._kf_created_reused > before[1]:
            # a reuse takes the head of the free list, not the cursor
            assert tr.n_kf == before[0] and before[2] and before[2][0] in tr.kf_order
        inserted += tr.n_kf - before[0] + tr._kf_created_reused - before[1]
    assert tr.track_state == tracking.TrackState.OK
    assert tr._kf_created_reused > 0 and inserted == tr.n_kf + tr._kf_created_reused
    live = tr.state.kf_valid.numpy().nonzero()[0].tolist()
    assert sorted(tr.kf_order) == live and len(live) < tr.n_kf + tr._kf_created_reused


def test_marathon_frames_match_the_scene():
    """lifetime's marathon scene (rendered chunk by chunk by
    render_frames) gives the same bytes as the generator's sequence
    quantised, which renders the reference's images to within half a gray
    level."""
    scene = lifetime.marathon_scene()
    assert len(scene[0][1]) == 1826 and len(scene[1][1]) == 150
    q = lambda x: np.clip(np.rint(x), 0, 255).astype(np.uint8)  # noqa: E731
    for w, (seed, kw) in enumerate(((31, dict(radius=3.0, wall_radius=9.0, n_points=1600,
                                               n_loop=320)),
                                    (77, dict(radius=2.0, wall_radius=6.0, n_points=1100,
                                              n_loop=151)))):
        world, R_wc, t_wc = scene[w]
        got = lifetime.render_frames(world, R_wc[:2], t_wc[:2])
        args = dict(n_frames=2, h=240, w=352, fx=260.0, baseline=0.2, dt=0.05, **kw)
        ref = tsyn.make_loop_stereo_sequence(np.random.default_rng(seed), **args)
        np.testing.assert_array_equal(got[0], q(ref.imgs_l))
        np.testing.assert_array_equal(got[1], q(ref.imgs_r))
        jref = jsyn.make_loop_stereo_sequence(np.random.default_rng(seed), **args)
        assert np.abs(ref.imgs_l - jref.imgs_l).max() < 0.5
        np.testing.assert_allclose(t_wc[:2], jref.t_wc, atol=1e-6)


def test_marathon_frames_in_processes(monkeypatch):
    """MarathonFrames renders the plan's chunks in spawned processes, in
    the order the run reads them: every pair equals the one-process render
    (the plan cut to 9 frames, chunks of 2)."""
    for name, value in (("MAR_N_A", 3), ("MAR_N_B", 2), ("MAR_N_C", 2), ("MAR_N_BLANK", 1),
                        ("MAR_RENDER_PROCS", 2), ("MAR_RENDER_CHUNK", 2)):
        monkeypatch.setattr(lifetime, name, value)
    scene = lifetime.marathon_scene()
    assert [len(R) for _, R, _ in scene] == [5, 2]
    with lifetime.MarathonFrames() as frames:
        assert list(frames._parts) == [(0, 0), (0, 2), (1, 0), (0, 4)]
        for w, i, _ in lifetime.marathon_plan():
            if w < 0:
                continue
            ref = lifetime.render_frames(scene[w][0], scene[w][1][i:i + 1],
                                         scene[w][2][i:i + 1])
            got = frames.pair(w, i)
            np.testing.assert_array_equal(got[0], ref[0][0])
            np.testing.assert_array_equal(got[1], ref[1][0])
        np.testing.assert_array_equal(frames.gt_t_wc, scene[0][2])


def jax_run(seq, cfg):
    """The JAX tracker over all of seq under cfg."""
    jt = trackers(seq, cfg)[0]
    for i in range(seq.imgs_l.shape[0]):
        jt.process_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
    return jt


def same_counts(out, jt):
    """The port run's slot counts against the JAX tracker's on the same
    frames: exact (integer bookkeeping on the same keyframe decisions)."""
    ref = dict(n_kf=jt.n_kf, reused=jt._kf_created_reused,
               created=jt.n_kf + jt._kf_created_reused, n_live=len(jt.kf_order))
    ref["max_keyframes"] = jt.cfg.map.max_keyframes
    assert {k: out[k] for k in ref} == ref


@pytest.fixture(scope="module")
def culling():
    """(the port's culling run, the JAX tracker after the same run)."""
    return lifetime.culling_run("cpu"), jax_run(*lifetime.culling_setup())


@pytest.mark.slow
def test_culling_bounds_keyframes(culling):
    """The JAX test's bars, its removal count with reused slots counted
    (lifetime.culling_run says why; the JAX package's own run ends at 14 live
    keyframes of 14 slots and fails its `n_live < n_kf`), and the JAX
    tracker's slot counts on the same run."""
    out, jt = culling
    _ok(out)
    assert out["n_live"] < out["created"] and out["ate_m"] < 0.02
    same_counts(out, jt)


@pytest.mark.slow
def test_trajectory_survives_culling(culling):
    out, jt = culling
    assert out["traj_live"]
    live = set(jt.kf_order)
    assert all(e[1] == -1 or e[1] in live for e in jt.traj)


@pytest.mark.slow
def test_long_sequence_stays_at_initial_tier():
    out = lifetime.slot_reuse_run("cpu")
    _ok(out)
    assert out["max_keyframes"] == 48 and out["created"] > 48
    same_counts(out, jax_run(*lifetime.slot_reuse_setup()))


@pytest.mark.slow
def test_retrieval_precision_recall_at_capacity():
    _ok(lifetime.retrieval_at_capacity("cpu"))


@pytest.mark.slow
def test_retrieval_at_1024_keyframes_grouped():
    _ok(lifetime.retrieval_grouped("cpu"))


@pytest.mark.slow
def test_jax_marathon_reference():
    """The JAX package's run of tests/test_marathon.py, where chip phase 21's
    reference numbers come from: the same scene, configuration and frame
    order, with jax.clear_caches() every 100 frames (the capacity tiers
    compile new programs as the map grows, and the plain test segfaults in a
    compile at the memory-map limit after ~20 minutes on the CPU). Prints
    the test's [marathon] line with the slot counts; asserts the gates the
    JAX package meets on its own run (its live keyframes exceed the test's
    220, see ROADMAP.md)."""
    import jax
    import jax.numpy as jnp
    import test_marathon as tm
    from orb_slam3_vio_fixes_tpu.evaluation import ate as jate
    from orb_slam3_vio_fixes_tpu.frontend import loop_closing as jlc
    from orb_slam3_vio_fixes_tpu.frontend import tracking as jtr
    from orb_slam3_vio_fixes_tpu.frontend.frame import build_stereo_frame
    from orb_slam3_vio_fixes_tpu.ops import orb as jorb
    from orb_slam3_vio_fixes_tpu.slam_map import atlas as jatlas
    from orb_slam3_vio_fixes_tpu.slam_map import map_state as jms
    from orb_slam3_vio_fixes_tpu.slam_map import vocabulary as jvoc
    from orb_slam3_vio_fixes_tpu.utils.cameras import Camera as JCamera

    seq, seq_b = tm._render_all()
    cam = JCamera.pinhole(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2])
    cfg = jtr.TrackerConfig(
        orb=jorb.ORBConfig(n_features=384, n_levels=4),
        map=jms.MapConfig(max_keyframes=64, max_landmarks=8192, max_features=384),
        width=tm.W, height=tm.H, max_local_lm=2048, ba_window=6, ba_fixed=2,
        new_lm_budget=256, max_frames_between_kf=6)
    pool = []
    for i in range(0, tm.N_LOOP, tm.N_LOOP // 8):
        f = build_stereo_frame(jnp.asarray(seq.imgs_l[i]), jnp.asarray(seq.imgs_r[i]),
                               jnp.float32(0.0), cam, jnp.float32(tm.FX * tm.BASELINE),
                               cfg.orb)
        pool.append(np.asarray(f.desc)[np.asarray(f.valid)])
    vocab = jvoc.train(np.concatenate(pool), branching=10, depth=3, seed=0)
    inv_s2 = jtr.octave_inv_sigma2(cfg.orb)
    closer = jlc.LoopCloser(vocab, cam, cfg.map.max_keyframes, inv_s2,
                            jlc.LoopConfig(min_gap_kfs=12, n_consistency=2, fix_scale=True),
                            bf=tm.FX * tm.BASELINE, n_levels=cfg.orb.n_levels,
                            scale=cfg.orb.scale)
    atl = jatlas.Atlas(cfg.map, vocab, cam, inv_s2, jatlas.AtlasConfig(min_stash_kfs=5))
    tr = jtr.StereoTracker(cam, tm.FX * tm.BASELINE, cfg, loop_closer=closer, atlas=atl)
    tr.max_lost_frames = 4
    blank = np.zeros((tm.H, tm.W), np.uint8)
    ts, circle = 0.0, []
    for n, (w, i, on_circle) in enumerate(lifetime.marathon_plan()):
        s = seq if w == 0 else seq_b
        tr.process_stereo(blank if w < 0 else s.imgs_l[i], blank if w < 0 else s.imgs_r[i], ts)
        if on_circle:
            circle.append((ts, i))
        ts += tm.DT
        if (n + 1) % 100 == 0:
            jax.clear_caches()
    tr.flush()
    traj = {round(t, 6): (R, t_) for t, R, t_ in tr.trajectory}
    est = [(t, -traj[round(t, 6)][0].T @ traj[round(t, 6)][1], seq.t_wc[i])
           for t, i in circle if round(t, 6) in traj]
    est_ts = np.array([e[0] for e in est])
    rmse, _, n_assoc = jate.ate_rmse(est_ts, np.array([e[2] for e in est]), est_ts,
                                     np.array([e[1] for e in est]))
    print(f"[marathon] jax frames={n + 1} kf_live={len(tr.kf_order)} n_kf={tr.n_kf} "
          f"loops={closer.n_corrections} merges={atl.n_merges} "
          f"reused={tr._kf_created_reused} max_keyframes={tr.cfg.map.max_keyframes} "
          f"posed={len(est)} ate={rmse!r}")
    assert tr.track_state == jtr.TrackState.OK
    assert closer.n_corrections >= 2 and atl.n_merges >= 1 and tr._kf_created_reused > 0
    assert tr.cfg.map.max_keyframes <= 512 and len(est) >= 0.95 * (tm.N_A + tm.N_C)
    assert n_assoc == len(est) and rmse < 0.5

