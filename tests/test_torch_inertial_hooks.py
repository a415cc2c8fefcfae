"""The stereo-inertial tracker's place-recognition hooks (port of the
LoopCloser / Relocalizer / Atlas wiring of
orb_slam3_vio_fixes_tpu/frontend/inertial_tracking.py) against the JAX
tracker's.

The scene is tests/test_e2e_inertial.py's (240x352, 400 features, 4
levels, IMU at 200 Hz) with a keyframe at least every 3 frames, so that the
map holds >= 10 keyframes when the track is lost. Cut for the test:
`recently_lost_time` = 0.2 s (4 blank frames of dead reckoning instead of
100).

Tolerances:
- the MergeInertialBA analogue's pose-fixed mask equal to the JAX
  tracker's; the VI BA it runs, from one converted state, within 1e-4 of
  the JAX package's run_global_vi_ba under that mask (keyframe centres,
  rotations and velocities), landmarks within 5 mm (landmark row 0 and the
  last keyframe / landmark slots left out, as in the slice-3/4 tests: the
  reference's compacted write-back and pad writes race there);
- the relocalisation branch: body state within 1e-6 of the JAX tracker's
  (the same float32 body_from_cam), prior_H, track state and counters
  exact;
- `_loop_enabled`, `_local_search_th` and the Atlas spawn exact.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from orb_slam3_vio_fixes_tpu.frontend import inertial_tracking as jit_
from orb_slam3_vio_fixes_tpu.frontend import tracking as jtr
from orb_slam3_vio_fixes_tpu.imu import preintegration as jpre
from orb_slam3_vio_fixes_tpu.io import synthetic as jsyn
from orb_slam3_vio_fixes_tpu.slam_map import map_state as jms
from orb_slam3_vio_fixes_tpu.utils.cameras import Camera as JCamera
from orb_slam3_vio_fixes_tpu_torch import convert
from orb_slam3_vio_fixes_tpu_torch.frontend import inertial_tracking as tit
from orb_slam3_vio_fixes_tpu_torch.frontend import tracking as ttr
from orb_slam3_vio_fixes_tpu_torch.imu import preintegration as tpre
from orb_slam3_vio_fixes_tpu_torch.slam_map import atlas as tatlas
from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary as tvoc
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera as TCamera

from test_torch_inertial_slice import IMU_NOISE, jax_configs
from test_torch_slice import port_cfg

torch.set_num_threads(2)

N_FRAMES = 36
LOST_TIME = 0.2


@pytest.fixture(scope="module")
def seq():
    rng = np.random.default_rng(5)
    world = jsyn.make_world(rng, n_points=600, extent=7.0, depth_range=(2.5, 9.0))
    return jsyn.make_stereo_inertial_sequence(
        rng, n_frames=N_FRAMES, h=240, w=352, fx=260.0, baseline=0.2, world=world,
        imu_hz=200.0, accel_amp=0.6)


def configs(seq):
    cfg, icfg = jax_configs(seq)
    icfg = jit_.InertialConfig(**{f: getattr(icfg, f) for f in tit.InertialConfig._fields
                                  if f != "recently_lost_time"},
                               recently_lost_time=LOST_TIME)
    return cfg._replace(max_frames_between_kf=3), icfg


def cams(seq):
    K = seq.K
    return (JCamera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
            TCamera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]))


def jax_tracker(seq, calib_kw=None):
    cfg, icfg = configs(seq)
    return jit_.StereoInertialTracker(
        cams(seq)[0], seq.K[0, 0] * seq.baseline,
        jpre.ImuCalib.make(*IMU_NOISE, seq.imu_hz, **(calib_kw or {})), cfg, icfg)


def port_tracker(seq, calib_kw=None, **kw):
    cfg, icfg = configs(seq)
    return tit.StereoInertialTracker(
        cams(seq)[1], seq.K[0, 0] * seq.baseline,
        tpre.ImuCalib.make(*IMU_NOISE, seq.imu_hz, device="cpu", **(calib_kw or {})),
        port_cfg(cfg), tit.InertialConfig(**{f: getattr(icfg, f) for f in tit.InertialConfig._fields}), device="cpu", **kw)


class CountingCloser:
    """Stands in for a LoopCloser: records whether the IMU was initialised
    at each keyframe it is shown, and never closes a loop."""

    mesh = None

    def __init__(self, n_keyframes):
        self.cfg = types.SimpleNamespace(min_gap_kfs=8)
        self.db = types.SimpleNamespace(hist=torch.zeros(n_keyframes, 1))
        self.tracker = None
        self.seen = []
        self.n_resets = 0

    def add_keyframe(self, state, kf_id):
        pass

    def on_keyframe(self, state, kf_id, n_kf, recent_slots=None):
        self.seen.append(self.tracker.imu_ready)
        return state, None

    def reset(self):
        self.n_resets += 1


@pytest.fixture(scope="module")
def run(seq):
    """The port tracker with a counting closer and an Atlas over every
    frame (the IMU initialises on the way), its map and IMU windows copied,
    then blank frames until the dead-reckoning budget runs out, then one
    real frame."""
    cfg, _ = configs(seq)
    rng = np.random.default_rng(0)
    vocab = tvoc.train(rng.integers(0, 2**32, (300, 8), dtype=np.uint32).view(np.int32),
                       branching=4, depth=2, seed=0, device="cpu")
    closer = CountingCloser(cfg.map.max_keyframes)
    atlas = tatlas.Atlas(port_cfg(cfg).map, vocab, cams(seq)[1],
                         ttr.octave_inv_sigma2(port_cfg(cfg).orb, "cpu"), device="cpu")
    tr = port_tracker(seq, loop_closer=closer, atlas=atlas)
    closer.tracker = tr
    for i in range(N_FRAMES):
        imu = seq.imu[i - 1] if i > 0 else np.zeros((0, 7), np.float32)
        tr.process_stereo_inertial(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i], imu)
    out = dict(tracker=tr, closer=closer, atlas=atlas, seen=list(closer.seen),
               imu_ready=tr.imu_ready, state_ok=tr.track_state,
               fields={f: a.copy() for f, a in convert.map_state_to_numpy(tr.state).items()},
               windows=dict(tr.kf_windows), kf_order=list(tr.kf_order), n_kf=tr.n_kf,
               n_lm=tr.n_lm, kf_inserts=tr._kf_seq)
    blank = np.zeros((240, 352), np.float32)
    states = []
    ts = seq.ts[-1]
    while not atlas.stored and len(states) < 10:
        ts += 0.05
        tr.process_stereo_inertial(blank, blank, ts, seq.imu[-1])
        states.append(tr.track_state)
    out.update(lost_states=states, after_loss=dict(
        stored=len(atlas.stored), map_id=tr.map_id, imu_ready=tr.imu_ready,
        windows=len(tr.kf_windows), n_kf=tr.n_kf, body=tr.body,
        resets=closer.n_resets))
    ts += 0.05
    tr.process_stereo_inertial(seq.imgs_l[-1], seq.imgs_r[-1], ts, seq.imu[-1])
    out["restart"] = (tr.track_state, list(tr.kf_order))
    return out


def test_loop_enabled_follows_imu_init(seq, run):
    """Place recognition only on a gravity-aligned, metric map: the closer
    sees no keyframe before the IMU initialisation (JAX:
    inertial_tracking.py:422-425), and sees the ones after it."""
    assert run["imu_ready"] and run["state_ok"] == ttr.TrackState.OK
    assert run["seen"] and all(run["seen"]), run["seen"]
    # the keyframes inserted before the initialisation (>= 3) went unseen
    assert len(run["seen"]) <= run["kf_inserts"] - 3
    jt, tt = jax_tracker(seq), port_tracker(seq)
    for ready in (False, True):
        jt.imu_ready = tt.imu_ready = ready
        assert tt._loop_enabled() is jt._loop_enabled() is ready


def test_imu_rgbd_local_search_th(seq):
    """IMU_RGBD sets th_local_base = 1.5; the inertial tracker searches at
    1.0 in the healthy states and widens only when degraded (JAX:
    inertial_tracking.py:427-439); the visual tracker keeps 1.5."""
    jt, tt = jax_tracker(seq), port_tracker(seq)
    cfg, _ = configs(seq)
    vt = ttr.StereoTracker(cams(seq)[1], seq.K[0, 0] * seq.baseline, port_cfg(cfg),
                           device="cpu")
    got = []
    for state, since in ((ttr.TrackState.OK, 10), (ttr.TrackState.OK, 1),
                         (ttr.TrackState.RECENTLY_LOST, 10), (ttr.TrackState.OK, 0)):
        for t in (jt, tt, vt):
            t.th_local_base = 1.5
            t.track_state, t.frames_since_reloc = state, since
        assert tt._local_search_th() == jt._local_search_th()
        got.append((tt._local_search_th(), vt._local_search_th()))
    assert got == [(1.0, 1.5), (2.0, 2.0), (3.0, 3.0), (2.0, 2.0)]


def test_relocalisation_keeps_inertial_state(seq):
    """A relocalisation hit while RECENTLY_LOST: the relocalised pose with
    the dead-reckoned velocity and biases, a weak prior (eye(15) * 1e2) and
    the counters reset, as in the JAX tracker (:542-567); with a camera
    offset from the body (T_bc not identity)."""
    rng = np.random.default_rng(3)
    R_bc = Rotation.from_rotvec([0.05, -0.1, 0.02]).as_matrix().astype(np.float32)
    t_bc = np.array([0.03, -0.01, 0.02], np.float32)
    R = Rotation.from_rotvec([0.2, 0.1, -0.3]).as_matrix().astype(np.float32)
    t = np.array([0.5, -0.2, 1.0], np.float32)
    body = [np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
            *(rng.normal(0, s, 3).astype(np.float32) for s in (1.0, 0.01, 0.1))]
    N = 400
    frame = types.SimpleNamespace(octave=np.zeros(N, np.int32), angle=np.zeros(N, np.float32))
    obs = np.arange(N, dtype=np.int32)
    out = {}
    for name, tr, arr, state_cls in (
            ("jax", jax_tracker(seq, dict(R_bc=jnp.asarray(R_bc), t_bc=jnp.asarray(t_bc))),
             jnp.asarray, jit_.BodyState),
            ("port", port_tracker(seq, dict(R_bc=R_bc, t_bc=t_bc)), torch.as_tensor,
             tit.BodyState)):
        hit = (arr(R), arr(t), arr(obs), 137)
        tr.relocalizer = types.SimpleNamespace(relocalize=lambda *a, hit=hit: hit)
        tr.track_state = ttr.TrackState.RECENTLY_LOST
        tr.body = state_cls(*(arr(x) for x in body))
        tr.prior_H = arr(np.eye(15, dtype=np.float32) * 1e6)
        tr.lost_frames, tr.frames_since_reloc, tr._lost_since = 7, 9, 0.3
        tr.vel = (arr(np.eye(3, dtype=np.float32)), arr(np.zeros(3, np.float32)))
        R_out, t_out, st = tr._track_inertial(frame, 0.5, np.zeros((4, 7), np.float32))
        out[name] = dict(body=[np.asarray(x) for x in tr.body], prior=np.asarray(tr.prior_H),
                         flags=(st, tr.track_state, tr.lost_frames, tr.frames_since_reloc,
                                tr._lost_since, tr.vel, tr.last_n_inliers),
                         pose=(np.asarray(R_out), np.asarray(t_out)))
    j, p = out["jax"], out["port"]
    assert p["flags"] == j["flags"] == ("OK", "OK", 0, 0, None, None, 137)
    np.testing.assert_array_equal(p["prior"], np.eye(15, dtype=np.float32) * 1e2)
    np.testing.assert_array_equal(p["prior"], j["prior"])
    for a, b in zip(p["body"], j["body"]):
        np.testing.assert_allclose(a, b, atol=1e-6)
    for a, b in zip(p["body"][2:], body[2:]):
        np.testing.assert_array_equal(a, b)      # velocity and biases kept
    for a, b in zip(p["pose"], (R, t)):
        np.testing.assert_array_equal(a, b)


def test_atlas_spawn_after_inertial_loss(run):
    """Blank frames after the IMU initialisation: RECENTLY_LOST while the
    IMU dead-reckons for `recently_lost_time` (cut to 0.2 s), then LOST: the
    map (>= 10 keyframes) goes to the Atlas and a new one starts
    (NOT_INITIALIZED) with the inertial state reset (JAX: :716-723,
    :762-764); the next real frame initialises it."""
    assert len(run["kf_order"]) >= 10
    states = run["lost_states"]
    assert states[-1] == ttr.TrackState.NOT_INITIALIZED
    assert set(states[:-1]) == {ttr.TrackState.RECENTLY_LOST}
    assert len(states) in (5, 6)        # 0.2 s of 0.05 s frames, float steps
    a = run["after_loss"]
    assert (a["stored"], a["map_id"], a["imu_ready"], a["windows"], a["n_kf"],
            a["body"]) == (1, 1, False, 0, 0, None)
    assert a["resets"] == 1
    assert run["atlas"].stored[0].n_kf == run["n_kf"]
    state, order = run["restart"]
    assert state == ttr.TrackState.OK and order == [0]


def test_post_merge_vi_ba_like_reference(seq, run, monkeypatch):
    """_post_merge after the IMU initialisation: the IMU windows follow the
    keyframes' slot offset, then the MergeInertialBA analogue (the seam
    window free, every other keyframe and the first live one fixed) against
    the JAX tracker's _post_merge on the same converted state. Before the
    initialisation the visual pose-graph _post_merge runs instead."""
    fields, order = run["fields"], run["kf_order"]
    new_kf = order[-1]
    tt = port_tracker(seq)
    tt.state = convert.map_state_from_numpy(fields, "cpu")
    adj, fixed = ttr.select_ba_window_impl(tt.state, new_kf, order[0], tt.cfg)
    masks = {}

    def setup(tr, state):
        tr.state = state
        tr.kf_windows = dict(run["windows"])
        tr.kf_order, tr.n_kf, tr.n_lm = list(order), run["n_kf"], run["n_lm"]
        tr.imu_ready = True
        real = tr._run_full_inertial_ba

        def captured(pose_fixed=None):
            masks[tr] = np.asarray(pose_fixed).copy()
            real(pose_fixed=pose_fixed)
        tr._run_full_inertial_ba = captured

    jt = jax_tracker(seq)
    setup(jt, jms.MapState(**{f: jnp.asarray(np.array(a, copy=True))
                              for f, a in fields.items()}))
    jt._post_merge(new_kf, 0, run["n_kf"], jnp.asarray(adj.numpy()),
                   jnp.asarray(fixed.numpy()))
    setup(tt, tt.state)
    tt._post_merge(new_kf, 0, run["n_kf"], adj, fixed)
    np.testing.assert_array_equal(masks[tt], masks[jt])
    free = np.nonzero(~masks[tt])[0]
    assert len(free) >= 3 and order[0] not in free and new_kf in free

    ref = {f: np.asarray(getattr(jt.state, f)) for f in jms.MapState._fields}
    got = convert.map_state_to_numpy(tt.state)
    live = np.asarray(order[:-1])
    C = {n: np.einsum("kji,kj->ki", s["kf_R"][live], -s["kf_t"][live])
         for n, s in (("got", got), ("ref", ref))}
    np.testing.assert_allclose(C["got"], C["ref"], atol=1e-4)
    for f in ("kf_R", "kf_vel", "kf_bg", "kf_ba"):
        np.testing.assert_allclose(got[f][live], ref[f][live], atol=1e-4, err_msg=f)
    assert np.abs(C["got"] - np.einsum("kji,kj->ki", fields["kf_R"][live],
                                       -fields["kf_t"][live])).max() > 1e-6
    lv = ref["lm_valid"].copy()
    lv[0] = lv[-1] = False
    np.testing.assert_array_equal(got["lm_valid"][:-1], ref["lm_valid"][:-1])
    np.testing.assert_allclose(got["lm_pos"][lv], ref["lm_pos"][lv], atol=5e-3)

    # the windows shift by the merge offset; before the IMU initialisation
    # the visual _post_merge runs
    calls, n_masks = [], len(masks)
    monkeypatch.setattr(ttr.StereoTracker, "_post_merge",
                        lambda self, *a: calls.append(a))
    tt.imu_ready = False
    tt.kf_windows = {k: w for k, w in run["windows"].items()}
    tt._post_merge(new_kf + 5, 5, run["n_kf"], adj + 5, fixed + 5)
    assert sorted(tt.kf_windows) == sorted(k + 5 for k in run["windows"])
    assert len(calls) == 1 and len(masks) == n_masks


def test_post_loop_gba_over_the_closer_mesh(seq, run, monkeypatch):
    """_post_loop_gba with a loop closer that carries a parallel.Mesh: the
    full-map VI BA runs landmark-sharded over it (the JAX tracker's
    inertial_tracking.py:970-978), from the same state as an unsharded
    tracker, and lands within test_vi_gba_sharded_parity_8_devices's bars
    of it: keyframe positions within 2e-3 m, relative-rotation traces above
    3 - 1e-4, the landmark median within 1e-3 m."""
    from orb_slam3_vio_fixes_tpu_torch.optim import vi_global_ba as tvg
    from orb_slam3_vio_fixes_tpu_torch.parallel import Mesh

    fields, order = run["fields"], run["kf_order"]
    sharded = []
    real = tvg.run_global_vi_ba_sharded
    monkeypatch.setattr(tvg, "run_global_vi_ba_sharded",
                        lambda *a, **k: sharded.append(a[7]) or real(*a, **k))
    out = {}
    for name, mesh in (("single", None), ("mesh", Mesh(["cpu"] * 2))):
        closer = CountingCloser(len(fields["kf_valid"]))
        closer.mesh = mesh
        tt = port_tracker(seq, loop_closer=closer)
        tt.state = convert.map_state_from_numpy({f: a.copy() for f, a in fields.items()},
                                                "cpu")
        tt.kf_windows = dict(run["windows"])
        tt.kf_order, tt.n_kf, tt.n_lm = list(order), run["n_kf"], run["n_lm"]
        tt.imu_ready = True
        tt._post_loop_gba(order[-1])
        out[name] = convert.map_state_to_numpy(tt.state)
    assert len(sharded) == 1 and isinstance(sharded[0], Mesh)
    a, b = out["mesh"], out["single"]
    live = np.asarray(order)
    np.testing.assert_allclose(a["kf_t"][live], b["kf_t"][live], atol=2e-3)
    for k in live:
        assert np.trace(a["kf_R"][k] @ b["kf_R"][k].T) > 3 - 1e-4
    assert np.abs(a["kf_t"][live] - fields["kf_t"][live]).max() > 1e-6
    lv = fields["lm_valid"]
    assert np.median(np.linalg.norm(a["lm_pos"] - b["lm_pos"], axis=-1)[lv]) < 1e-3
