"""The port's relocalisation (frontend/relocalization.py), Atlas
(slam_map/atlas.py) and snapshots (slam_map/snapshot.py).

Port twins of tests/test_relocalization.py::test_relocalize_after_blackout
and tests/test_atlas.py::test_atlas_spawn_and_merge with their bars; then,
on a map the JAX StereoTracker builds over the same 12 frames, converted:
reloc_attempt parity (the PnP samples drawn by jax.random, as in
test_torch_loop), merge_maps parity, and snapshots saved by one package and
loaded by the other.

Tolerances: candidate ids, BoW match counts and the success flag exact;
the relocalised pose within 1e-3 and its inlier count within 2 (two
float32 pose optimisations); merged maps within 1e-5 (poses, landmarks)
and exact elsewhere, leaving out the last keyframe and landmark slots,
where the reference's pad writes race (ROADMAP queue 3); snapshots exact.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu.frontend import loop_closing as jlc
from orb_slam3_vio_fixes_tpu.frontend import relocalization as jrl
from orb_slam3_vio_fixes_tpu.frontend import tracking as jtr
from orb_slam3_vio_fixes_tpu.frontend.frame import build_mono_frame, build_stereo_frame
from orb_slam3_vio_fixes_tpu.io import synthetic as jsyn
from orb_slam3_vio_fixes_tpu.ops import orb as jorb
from orb_slam3_vio_fixes_tpu.slam_map import atlas as jatlas
from orb_slam3_vio_fixes_tpu.slam_map import map_state as jms
from orb_slam3_vio_fixes_tpu.slam_map import snapshot as jsnap
from orb_slam3_vio_fixes_tpu.slam_map import vocabulary as jvoc
from orb_slam3_vio_fixes_tpu.utils.cameras import Camera as JCamera
from orb_slam3_vio_fixes_tpu_torch import convert
from orb_slam3_vio_fixes_tpu_torch.frontend import loop_closing as tlc
from orb_slam3_vio_fixes_tpu_torch.frontend import relocalization as trl
from orb_slam3_vio_fixes_tpu_torch.frontend import tracking as ttr
from orb_slam3_vio_fixes_tpu_torch.slam_map import atlas as tatlas
from orb_slam3_vio_fixes_tpu_torch.slam_map import snapshot as tsnap
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera as TCamera

from test_torch_loop import jax_pnp_draws, port_vocab
from test_torch_slice import port_cfg

torch.set_num_threads(2)

H, W, FX, BASELINE = 240, 352, 260.0, 0.2
K_CAM = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]], np.float32)
JCAM = JCamera.pinhole(FX, FX, W / 2, H / 2)
TCAM = TCamera.pinhole(FX, FX, W / 2, H / 2)


@pytest.fixture(scope="module")
def scene():
    """The reloc/Atlas tests' world and 12-pose trajectory, a renderer and
    the b8d2 vocabulary trained on frame 0 (JAX and port copies)."""
    def make(seed):
        rng = np.random.default_rng(seed)
        world = jsyn.make_world(rng, n_points=600, extent=7.0, depth_range=(2.5, 9.0))
        R_wc, t_wc = jsyn.orbit_trajectory(12, 0.05, speed=(0.8, 0.0, 0.1),
                                           yaw_rate=0.05)

        def stereo_at(i):
            Rw, tw = R_wc[i], t_wc[i]
            R_cw = Rw.T
            img_l = jsyn.render(world, K_CAM, R_cw, -R_cw @ tw, H, W)
            C_r = tw + Rw @ np.array([BASELINE, 0, 0], np.float32)
            return img_l, jsyn.render(world, K_CAM, R_cw, -R_cw @ C_r, H, W)

        frames = [stereo_at(i) for i in range(12)]
        f0 = build_mono_frame(jnp.asarray(frames[0][0]), jnp.float32(0.0),
                              jorb.ORBConfig(n_features=400, n_levels=4))
        vocab = jvoc.train(np.asarray(f0.desc)[np.asarray(f0.valid)], branching=8,
                           depth=2, seed=0)
        return dict(frames=frames, t_wc=t_wc, vocab=vocab, tvocab=port_vocab(vocab))
    return {"reloc": make(3), "atlas": make(5)}


def _cfg(max_landmarks, kf_every):
    return jtr.TrackerConfig(
        orb=jorb.ORBConfig(n_features=400, n_levels=4),
        map=jms.MapConfig(max_keyframes=32, max_landmarks=max_landmarks, max_features=400),
        width=W, height=H, max_local_lm=1024, ba_window=6, ba_fixed=2,
        new_lm_budget=256, max_frames_between_kf=kf_every)


def _port_tracker(sc, jcfg, atlas_cfg=None):
    cfg = port_cfg(jcfg)
    inv_s2 = ttr.octave_inv_sigma2(cfg.orb, "cpu")
    closer = tlc.LoopCloser(sc["tvocab"], TCAM, cfg.map.max_keyframes, inv_s2,
                            tlc.LoopConfig(min_gap_kfs=10**6), device="cpu")
    reloc = atl = None
    if atlas_cfg is None:
        reloc = trl.Relocalizer(sc["tvocab"], lambda: closer.db, device="cpu")
    else:
        atl = tatlas.Atlas(cfg.map, sc["tvocab"], TCAM, inv_s2, atlas_cfg, device="cpu")
    tr = ttr.StereoTracker(TCAM, FX * BASELINE, cfg, device="cpu", loop_closer=closer,
                           relocalizer=reloc, atlas=atl)
    return tr, closer, reloc, atl


def test_relocalize_after_blackout(scene):
    sc = scene["reloc"]
    tr, _, reloc, _ = _port_tracker(sc, _cfg(4096, 4))
    ts = 0.0
    for i in range(12):
        tr.process_stereo(*sc["frames"][i], ts)
        ts += 0.05
    assert tr.track_state == ttr.TrackState.OK
    blank = np.zeros((H, W), np.float32)
    for _ in range(4):
        tr.process_stereo(blank, blank, ts)
        ts += 0.05
    assert tr.track_state in (ttr.TrackState.RECENTLY_LOST, ttr.TrackState.LOST)
    tr.process_stereo(*sc["frames"][6], ts)
    assert tr.track_state == ttr.TrackState.OK
    assert reloc.n_success == 1
    C_est = -tr.R.numpy().T @ tr.t.numpy()
    assert np.linalg.norm(C_est - sc["t_wc"][6]) < 0.05


def test_atlas_spawn_and_merge(scene):
    sc = scene["atlas"]
    tr, _, _, atl = _port_tracker(sc, _cfg(8192, 3), tatlas.AtlasConfig(min_stash_kfs=3))
    tr.max_lost_frames = 3
    ts = 0.0
    for i in range(12):
        tr.process_stereo(*sc["frames"][i], ts)
        ts += 0.05
    assert tr.track_state == ttr.TrackState.OK and tr.n_kf >= 3
    blank = np.zeros((H, W), np.float32)
    for _ in range(6):
        tr.process_stereo(blank, blank, ts)
        ts += 0.05
    assert len(atl.stored) == 1 and tr.map_id == 1
    assert tr.track_state == ttr.TrackState.NOT_INITIALIZED
    for i in range(2, 12):
        tr.process_stereo(*sc["frames"][i], ts)
        ts += 0.05
    assert tr.track_state == ttr.TrackState.OK
    assert atl.n_merges == 1, "map merge did not fire"
    assert len(atl.stored) == 0 and tr.map_id == 2
    C_est = -tr.R.numpy().T @ tr.t.numpy()
    assert np.linalg.norm(C_est - sc["t_wc"][11]) < 0.10, C_est


@pytest.fixture(scope="module")
def jax_map(scene):
    """The JAX StereoTracker's map after the reloc scene's 12 frames (numpy
    fields), its database rows, and the JAX frame at pose 6."""
    sc = scene["reloc"]
    jcfg = _cfg(4096, 4)
    closer = jlc.LoopCloser(sc["vocab"], JCAM, 32, jtr.octave_inv_sigma2(jcfg.orb),
                            jlc.LoopConfig(min_gap_kfs=10**6))
    tr = jtr.StereoTracker(JCAM, FX * BASELINE, jcfg, loop_closer=closer)
    for i in range(12):
        tr.process_stereo(*sc["frames"][i], 0.05 * i)
    frame = build_stereo_frame(jnp.asarray(sc["frames"][6][0]), jnp.asarray(sc["frames"][6][1]),
                               jnp.float32(1.0), JCAM, jnp.float32(FX * BASELINE), jcfg.orb)
    return dict(fields={f: np.array(getattr(tr.state, f), copy=True)
                        for f in tr.state._fields},
                n_kf=tr.n_kf, n_lm=tr.n_lm, kf_order=list(tr.kf_order),
                hist=np.array(closer.db.hist, copy=True), cfg=jcfg,
                frame={f: np.array(getattr(frame, f)) for f in frame._fields})


def _jstate(fields):
    return jms.MapState(**{f: jnp.asarray(np.array(a, copy=True)) for f, a in fields.items()})


def test_reloc_attempt_agrees(scene, jax_map, monkeypatch):
    sc, m = scene["reloc"], jax_map
    jstate, tstate = _jstate(m["fields"]), convert.map_state_from_numpy(m["fields"], "cpu")
    from orb_slam3_vio_fixes_tpu.frontend.frame import FrameData as JFrame

    jframe = JFrame(**{f: jnp.asarray(a) for f, a in m["frame"].items()})
    tframe = convert.frame_from_numpy(m["frame"], "cpu")
    jdb = jvoc.KeyFrameDatabase(jnp.asarray(m["hist"]))
    tdb = convert.keyframe_database_from_numpy(m["hist"], "cpu")
    jrel = jrl.Relocalizer(sc["vocab"], lambda: jdb)
    trel = trl.Relocalizer(sc["tvocab"], lambda: tdb, device="cpu")
    cands = jrel.candidates(jstate, jframe)
    assert trel.candidates(tstate, tframe) == cands and cands
    cov = np.asarray(jms.covisibility(jstate))
    row = cov[cands[0]].copy()
    row[cands[0]] = row.max() + 1
    top = np.argsort(-row)[:8]
    top = np.where(row[top] > 0, top, -1)
    key = jax.random.split(jax.random.PRNGKey(13))[1]
    jout = jrl.reloc_attempt(key, jstate, jnp.int32(cands[0]), jframe,
                             jnp.asarray(top.astype(np.int32)), JCAM,
                             jnp.float32(FX * BASELINE), jrl.RelocConfig(), m["cfg"])
    jax_pnp_draws(monkeypatch, key, per_call=False)
    tout = trl.reloc_attempt(None, tstate, cands[0], tframe, torch.as_tensor(top), TCAM,
                             FX * BASELINE, trl.RelocConfig(), port_cfg(m["cfg"]))
    assert bool(tout[0]) == bool(jout[0]) is True
    assert int(tout[5]) == int(jout[5])
    assert abs(int(tout[4]) - int(jout[4])) <= 2
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), atol=1e-3)
    np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]), atol=1e-3)
    C = -tout[1].numpy().T @ tout[2].numpy()
    assert np.linalg.norm(C - sc["t_wc"][6]) < 0.05


def test_relocalize_global_agrees(scene, jax_map, monkeypatch):
    """The mesh path (Relocalizer(mesh=...)._relocalize_global) on the JAX
    tracker's map and the frame at pose 6: the sharded whole-map search
    binds the same landmarks as the JAX package's on its 8 virtual devices
    (exact), and with the PnP samples drawn by jax.random under the JAX
    relocaliser's key chain the relocalised pose agrees within 1e-4 and the
    inlier count within 2; back at pose 6 within 5 cm."""
    from jax.sharding import Mesh as JMesh

    from orb_slam3_vio_fixes_tpu.frontend.frame import FrameData as JFrame
    from orb_slam3_vio_fixes_tpu.parallel import sharded_matching as jsm
    from orb_slam3_vio_fixes_tpu_torch.parallel import Mesh
    from orb_slam3_vio_fixes_tpu_torch.parallel import sharded_matching as tsm

    sc, m = scene["reloc"], jax_map
    jstate, tstate = _jstate(m["fields"]), convert.map_state_from_numpy(m["fields"], "cpu")
    jframe = JFrame(**{f: jnp.asarray(a) for f, a in m["frame"].items()})
    tframe = convert.frame_from_numpy(m["frame"], "cpu")
    jmesh = JMesh(np.array(jax.devices()[:8]), ("db",))
    tmesh = Mesh(["cpu"] * 8, ("db",))
    jids = np.asarray(jsm.sharded_global_bind(jframe.desc, jframe.valid, jstate.lm_desc,
                                              jstate.lm_valid, jmesh, axis="db"))
    tids = tsm.sharded_global_bind(tframe.desc, tframe.valid, tstate.lm_desc,
                                   tstate.lm_valid, tmesh, axis="db").numpy()
    np.testing.assert_array_equal(tids, jids)
    assert (tids >= 0).sum() >= trl.RelocConfig().min_bow_matches
    jrel = jrl.Relocalizer(sc["vocab"], lambda: None, mesh=jmesh)
    trel = trl.Relocalizer(sc["tvocab"], lambda: None, mesh=tmesh, device="cpu")
    bf = FX * BASELINE
    jout = jrel._relocalize_global(jstate, jframe, JCAM, jnp.float32(bf), m["cfg"])
    jax_pnp_draws(monkeypatch, jax.random.split(jax.random.PRNGKey(13))[1], per_call=False)
    tout = trel._relocalize_global(tstate, tframe, TCAM, bf, port_cfg(m["cfg"]))
    assert jout is not None and tout is not None
    assert trel.n_success_global == jrel.n_success_global == 1
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), atol=1e-4)
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), atol=1e-4)
    assert abs(tout[3] - jout[3]) <= 2
    C = -tout[0].numpy().T @ tout[1].numpy()
    assert np.linalg.norm(C - sc["t_wc"][6]) < 0.05


@pytest.mark.parametrize("s_a", [1.0, 1.05])
def test_merge_maps_agrees(jax_map, s_a):
    m = jax_map
    R_a = np.asarray(jax.scipy.linalg.expm(jnp.asarray(
        [[0, -0.1, 0.05], [0.1, 0, -0.02], [-0.05, 0.02, 0]], jnp.float32)))
    t_a = np.array([0.3, -0.1, 0.2], np.float32)
    jm = jatlas.merge_maps(_jstate(m["fields"]), _jstate(m["fields"]), jnp.int32(m["n_kf"]),
                           jnp.int32(m["n_lm"]), jnp.asarray(R_a), jnp.asarray(t_a),
                           jnp.float32(s_a))
    tm = tatlas.merge_maps(convert.map_state_from_numpy(m["fields"], "cpu"),
                           convert.map_state_from_numpy(m["fields"], "cpu"), m["n_kf"],
                           m["n_lm"], torch.as_tensor(R_a), torch.as_tensor(t_a), s_a)
    tn = convert.map_state_to_numpy(tm)
    for f in jms.MapState._fields:
        a, b = tn[f], np.asarray(getattr(jm, f))
        if f != "epoch":    # leave out the last keyframe / landmark slot
            a, b = a[:-1], b[:-1]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, atol=1e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert int(tm.kf_valid.sum()) == 2 * int(np.asarray(m["fields"]["kf_valid"]).sum())


def test_snapshot_round_trip(scene, jax_map, tmp_path):
    sc, m = scene["reloc"], jax_map
    jstate = _jstate(m["fields"])
    stored = [jatlas.StoredMap(_jstate(m["fields"]), m["n_kf"], m["n_lm"],
                               m["hist"][:m["n_kf"]])]
    jcfg = m["cfg"].map
    p1 = str(tmp_path / "jax_atlas.npz")
    jsnap.save_atlas(p1, jstate, jcfg, m["n_kf"], m["n_lm"], m["kf_order"], stored,
                     hists=m["hist"], vocab=sc["vocab"])
    st, cfg, meta, hists, tstored, tvocab = tsnap.load_atlas(p1, vocab=sc["tvocab"],
                                                              device="cpu")
    assert tuple(cfg) == tuple(jcfg) and meta["kf_order"] == m["kf_order"]
    np.testing.assert_array_equal(hists, m["hist"])
    sm = convert.stored_map_from_numpy(m["fields"], m["n_kf"], m["n_lm"],
                                       m["hist"][:m["n_kf"]], "cpu")
    assert (sm.n_kf, sm.n_lm) == tuple(tstored[0][1:3])
    np.testing.assert_array_equal(sm.hists, tstored[0][3])
    for f, a in convert.map_state_to_numpy(st).items():
        np.testing.assert_array_equal(a, m["fields"][f], err_msg=f)
        np.testing.assert_array_equal(convert.map_state_to_numpy(tstored[0][0])[f],
                                      m["fields"][f], err_msg=f)
        np.testing.assert_array_equal(convert.map_state_to_numpy(sm.state)[f],
                                      m["fields"][f], err_msg=f)
    assert tsnap.vocab_checksum(tvocab) == jsnap.vocab_checksum(sc["vocab"])
    p2 = str(tmp_path / "port_atlas.npz")
    tsnap.save_atlas(p2, st, cfg, m["n_kf"], m["n_lm"], m["kf_order"],
                     [tatlas.StoredMap(*tstored[0])], hists=hists, vocab=tvocab)
    js, jcfg2, jmeta, jh, jstored, jv = jsnap.load_atlas(p2, vocab=sc["vocab"])
    np.testing.assert_array_equal(jh, m["hist"])
    assert jmeta["stored"] == meta["stored"]
    for f in jms.MapState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(js, f)), m["fields"][f], err_msg=f)
        np.testing.assert_array_equal(np.asarray(getattr(jstored[0][0], f)), m["fields"][f])
    p3 = str(tmp_path / "port_map.npz")
    tsnap.save_map(p3, st, cfg, m["n_kf"], m["n_lm"], vocab=tvocab, extra={"a": 1})
    js3, _, n_kf, n_lm, _, extra = jsnap.load_map(p3, vocab=sc["vocab"])
    assert (n_kf, n_lm, extra) == (m["n_kf"], m["n_lm"], {"a": 1})
    np.testing.assert_array_equal(np.asarray(js3.kf_desc), m["fields"]["kf_desc"])
    with pytest.raises(tsnap.SnapshotError):
        tsnap.load_map(p3, vocab=port_vocab(jvoc.train(m["fields"]["kf_desc"][0, :200],
                                                        branching=4, depth=2)),
                       device="cpu")


def _so3(axis, angle):
    """Rotation by `angle` about the unit `axis` (Rodrigues)."""
    k = np.asarray(axis, np.float64)
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(angle) * Kx + (1 - np.cos(angle)) * Kx @ Kx


@pytest.mark.parametrize("since_init", [10.0, 0.5], ids=["settled", "just_initialised"])
def test_inertial_merge_keeps_gravity(since_init, monkeypatch, tmp_path):
    """A marginal merge hit replayed through an IMU_STEREO facade's tracker:
    the verified Sim3 carries a 2-degree roll error (a 17-inlier hit).
    Inertial maps are gravity-aligned, so once the active map's IMU has had
    5 s of data since its initialisation (`settled`) the merge keeps only
    the Sim3's yaw and translation: every merged-in keyframe's body-frame
    gravity stays within 0.1 degree of its value before the merge (with the
    full Sim3 it tilts by the 2 degrees). Half a second after the
    initialisation (`just_initialised`) the map's gravity is not trusted
    yet and the full Sim3 applies."""
    from orb_slam3_vio_fixes_tpu_torch import system as sysm
    from orb_slam3_vio_fixes_tpu_torch.ops import sim3 as tsim3
    from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as tms

    from test_torch_system import IMU_YAML, small_map

    path = tmp_path / "imu.yaml"
    path.write_text(IMU_YAML)
    slam = sysm.SLAMSystem(str(path), sysm.Sensor.IMU_STEREO, map_cfg=small_map(),
                           device="cpu")
    tr = slam.tracker
    tr.loop_closer = None
    cfg = tr.cfg.map
    g = np.array([0.0, 0.0, -1.0])

    def gravity_aligned_map(poses, n_lm):
        st = tms.empty(cfg, "cpu")
        for k, (R_wc, C) in enumerate(poses):
            st.kf_R[k] = torch.as_tensor(R_wc.T, dtype=torch.float32)
            st.kf_t[k] = torch.as_tensor(-R_wc.T @ C, dtype=torch.float32)
            st.kf_valid[k] = True
            st.kf_ts[k] = 0.1 * k
        st.lm_pos[:n_lm] = torch.randn(n_lm, 3, generator=torch.Generator().manual_seed(0))
        st.lm_valid[:n_lm] = True
        return st

    # a camera looking along the world's +x axis (z forward, y down)
    R0 = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    active = [(_so3([0, 0, 1], 0.1 * k) @ R0, np.array([0.3 * k, 0.1, 0.0])) for k in range(3)]
    stored = [(_so3([0, 0, 1], 0.4) @ R0, np.array([2.0, -1.0, 0.0]))]
    tr.state = gravity_aligned_map(active, 20)
    tr.n_kf, tr.n_lm, tr.kf_order = 3, 20, [0, 1, 2]
    tr._kf_nlm_dev = torch.tensor(20)
    tr.imu_ready = True
    tr.t_imu_init = float(tr.state.kf_ts[2]) - since_init
    hists = np.zeros((1, 4), np.float32)
    slam.atlas.stored = [tatlas.StoredMap(gravity_aligned_map(stored, 10), 1, 10, hists)]
    monkeypatch.setattr(slam.atlas, "detect_merge", lambda state, kf: (0, 0))
    # the true alignment (active world -> stored world: a yaw and a shift),
    # measured with a 2-degree roll error about the candidate camera's axis
    Rw, tw = _so3([0, 0, 1], 0.25), np.array([0.5, -0.2, 0.0])
    R_cur, t_cur = tr.state.kf_R[2].numpy(), tr.state.kf_t[2].numpy()
    st = slam.atlas.stored[0].state
    R_cand, t_cand = st.kf_R[0].numpy(), st.kf_t[0].numpy()
    R_s = R_cur @ Rw.T @ R_cand.T
    t_s = R_cur @ Rw.T @ (-R_cand.T @ t_cand - tw) + t_cur
    R_s = R_s @ _so3([0, 0, 1], np.radians(2.0))
    N = cfg.max_features
    sim = tsim3.Sim3Result(torch.as_tensor(R_s, dtype=torch.float32),
                           torch.as_tensor(t_s, dtype=torch.float32), torch.tensor(1.0),
                           torch.zeros(N, dtype=torch.bool), torch.tensor(17))
    monkeypatch.setattr(tatlas, "verify_cross_candidate",
                        lambda *a, **k: (torch.tensor(60), torch.tensor(60), sim))
    merged = []
    monkeypatch.setattr(tr, "_adopt_merge", lambda res, kf_id: merged.append(res) or kf_id)
    before = tr.state.kf_R[:3].numpy().copy()
    tr._kf_stage_finalize(2)
    assert len(merged) == 1 and slam.atlas.n_merges == 1
    state, _, _, kf_off, _ = merged[0]
    after = state.kf_R[kf_off:kf_off + 3].numpy()
    cos = np.clip(np.einsum("ki,ki->k", before @ g, after @ g), -1.0, 1.0)
    tilt = np.degrees(np.arccos(cos))
    if since_init < 5.0:
        assert np.abs(tilt - 2.0).max() < 0.01, tilt
        return
    assert tilt.max() < 0.1, tilt
    # the yaw and the seam are those of the measurement
    C_cur = -after[2].T @ state.kf_t[kf_off + 2].numpy()
    assert np.linalg.norm(C_cur - (Rw @ active[2][1] + tw)) < 0.05
