"""The port's facade and host layers against the JAX package: settings
(the port's own OpenCV-YAML parser), rectification and remaps, trajectory
writers, dataset loaders, and the twins of tests/test_system.py.

Tolerances:
- every configs/*.yaml parses to the same Settings, field by field and
  exactly (cameras as float32 scalars), before and after the rectification
  / undistortion precompute;
- stereo_rectify and init_undistort_rectify_map equal to JAX's (the same
  float64 numpy code); remap_bilinear / remap_nearest within 1e-4 of JAX's
  on EuRoC.yaml's maps (float32 gathers, the same tap arithmetic);
- trajectory files byte-equal to the JAX writers' for the same trajectory;
- the dataset loaders return the same index (paths, stamps, IMU arrays) on
  tests/test_datasets.py's fixtures;
- the monocular modes through track_monocular: MONOCULAR under
  tests/test_e2e_mono.py's bar (scale-aligned ATE < 0.10 m), IMU_MONOCULAR
  tracking OK after its two-view initialisation;
- the facade twins under tests/test_system.py's bars (state OK, >= 2
  keyframes, localisation mode relocalises into a loaded map without adding
  keyframes, camera centre within 0.1 m); the stereo run also against the
  JAX package's SLAMSystem on the same frames and configuration: the same
  keyframe count, ATE within 1.5x + 5 mm of the JAX one.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu.io import datasets as jds
from orb_slam3_vio_fixes_tpu.io import settings as jset
from orb_slam3_vio_fixes_tpu import system as jsys
from orb_slam3_vio_fixes_tpu.io import trajectory as jtraj
from orb_slam3_vio_fixes_tpu.ops import rectify as jrec
from orb_slam3_vio_fixes_tpu.sensors import Sensor as JSensor
from orb_slam3_vio_fixes_tpu_torch import system as sysm
from orb_slam3_vio_fixes_tpu_torch.evaluation import ate
from orb_slam3_vio_fixes_tpu_torch.frontend import tracking
from orb_slam3_vio_fixes_tpu_torch.frontend.frame import build_stereo_frame_impl
from orb_slam3_vio_fixes_tpu_torch.frontend.inertial_tracking import MonoInertialTracker
from orb_slam3_vio_fixes_tpu_torch.frontend.mono_tracking import MonocularTracker
from orb_slam3_vio_fixes_tpu_torch.io import datasets as tds
from orb_slam3_vio_fixes_tpu_torch.io import settings as tset
from orb_slam3_vio_fixes_tpu_torch.io import synthetic
from orb_slam3_vio_fixes_tpu_torch.io import trajectory as ttraj
from orb_slam3_vio_fixes_tpu_torch.ops import orb
from orb_slam3_vio_fixes_tpu_torch.ops import rectify as trec
from orb_slam3_vio_fixes_tpu_torch.parallel import Mesh
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms
from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary as voc

from test_datasets import _write_png, euroc_dir  # noqa: F401  (fixture)
from test_system import YAML
from test_system import small_map as jax_small_map
from test_system import small_tracker_cfg as jax_small_tracker_cfg

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs")
CONFIGS = [("EuRoC.yaml", "STEREO"), ("EuRoC.yaml", "IMU_STEREO"),
           ("TUM-VI.yaml", "IMU_STEREO"), ("KITTI00-02.yaml", "STEREO"),
           ("TUM1.yaml", "RGBD"), ("D455.yaml", "RGBD")]


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(b, tset.Camera):
        return ([float(np.float32(x)) for x in (a.fx, a.fy, a.cx, a.cy)]
                == [b.fx, b.fy, b.cx, b.cy]
                and np.array_equal(np.asarray(a.dist, np.float32),
                                   np.asarray(b.dist, np.float32)) and a.kind == b.kind)
    if isinstance(b, trec.StereoRectification):
        return all(np.array_equal(x, y) for x, y in zip(a, b))
    if isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), b)
    if isinstance(b, sysm.Sensor):
        return a.name == b.name
    return a == b and type(a) is type(b)


def test_configs_parse_like_reference():
    remaps = []
    for name, sensor in CONFIGS:
        path = os.path.join(CFG, name)
        ref = jset.load_settings(path, getattr(JSensor, sensor))
        got = tset.load_settings(path, getattr(sysm.Sensor, sensor))
        assert tset.parse_yaml(open(path).read()) == jset._load_yaml(path), name
        for stage in ("parsed", "precomputed"):
            bad = [f for f in tset.Settings.__dataclass_fields__
                   if not _same(getattr(ref, f), getattr(got, f))]
            assert not bad, (name, sensor, stage, bad)
            ref.precompute_rectification()
            ref.precompute_undistortion()
            got.precompute_rectification()
            got.precompute_undistortion()
        remaps.append((got.rect is not None, got.undist_map is not None))
    # EuRoC's distorted pair is rectified, TUM1's distorted camera undistorted
    assert remaps[0] == (True, False) and remaps[4] == (False, True)


def test_rectify_and_remaps_match_reference():
    s = tset.load_settings(os.path.join(CFG, "EuRoC.yaml"), sysm.Sensor.STEREO)
    K1 = tset.camera_matrix(s.cam1)
    K2 = tset.camera_matrix(s.cam2)
    got = trec.stereo_rectify(K1, s.dist1, K2, s.dist2, (752, 480), s.T_c1_c2)
    ref = jrec.stereo_rectify(K1, s.dist1, K2, s.dist2, (752, 480), s.T_c1_c2)
    for f in trec.StereoRectification._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    np.testing.assert_array_equal(
        trec.init_undistort_rectify_map(K1, s.dist1, np.eye(3), K1, (752, 480)),
        jrec.init_undistort_rectify_map(K1, s.dist1, np.eye(3), K1, (752, 480)))
    rng = np.random.default_rng(0)
    pair = rng.uniform(0, 255, (2, 480, 752)).astype(np.float32)
    maps = np.stack([got.map1, got.map2])
    # a map with taps outside the image on every side
    maps[0, :8] += np.float32(-30.0)
    maps[1, -8:] += np.float32(40.0)
    for i in range(2):
        out = trec.remap_bilinear(torch.from_numpy(pair[i]), torch.from_numpy(maps[i]))
        exp = np.asarray(jrec.remap_bilinear(jnp.asarray(pair[i]), jnp.asarray(maps[i])))
        np.testing.assert_allclose(out.numpy(), exp, atol=1e-4)
        near = trec.remap_nearest(torch.from_numpy(pair[i]), torch.from_numpy(maps[i]))
        np.testing.assert_allclose(
            near.numpy(), np.asarray(jrec.remap_nearest(jnp.asarray(pair[i]),
                                                        jnp.asarray(maps[i]))), atol=1e-4)
    batched = trec.remap_bilinear(torch.from_numpy(pair), torch.from_numpy(maps[0]))
    np.testing.assert_allclose(
        batched.numpy(), np.asarray(jrec.remap_bilinear(jnp.asarray(pair),
                                                        jnp.asarray(maps[0]))), atol=1e-4)


def test_trajectory_files_byte_equal(tmp_path):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(4)
    Rs = Rotation.random(200, random_state=4).as_matrix()
    traj = [(1403636579.7635 + 0.05 * i, R, rng.normal(0, 3, 3)) for i, R in enumerate(Rs)]
    traj.append((0.0, np.eye(3), np.zeros(3)))
    traj.append((2.5, np.diag([1.0, -1.0, -1.0]), np.ones(3)))
    for fn in ("save_tum", "save_euroc", "save_kitti"):
        a, b = tmp_path / f"j_{fn}.txt", tmp_path / f"t_{fn}.txt"
        getattr(jtraj, fn)(str(a), traj)
        getattr(ttraj, fn)(str(b), traj)
        assert a.read_bytes() == b.read_bytes(), fn
    for got, ref in zip(ttraj.load_tum(str(tmp_path / "t_save_tum.txt")),
                        jtraj.load_tum(str(tmp_path / "j_save_tum.txt"))):
        np.testing.assert_array_equal(got, ref)


def test_dataset_loaders_match_reference(euroc_dir, tmp_path):  # noqa: F811
    root, stamps = euroc_dir

    def same(a, b):
        assert (a.left, a.right, a.depth, a.depth_factor) == (b.left, b.right, b.depth,
                                                              b.depth_factor)
        np.testing.assert_array_equal(a.ts, b.ts)
        assert (a.imu is None) == (b.imu is None)
        if a.imu is not None:
            for f in ("ts", "gyro", "acc"):
                np.testing.assert_array_equal(getattr(a.imu, f), getattr(b.imu, f))
        for i in range(len(a)):
            for x, y in zip(a.frame(i), b.frame(i)):
                assert (x is None and y is None) or np.array_equal(x, y)

    same(tds.load_euroc(root), jds.load_euroc(root))
    tf = tmp_path / "ts.txt"
    tf.write_text("\n".join(str(s) for s in stamps[1:3]))
    same(tds.load_euroc(root, timestamps_file=str(tf), with_imu=False),
         jds.load_euroc(root, timestamps_file=str(tf), with_imu=False))
    a, b = tds.load_euroc(root), jds.load_euroc(root)
    for x, y in zip(a.imu_between(a.ts[0], a.ts[2]).__dict__.values(),
                    b.imu_between(b.ts[0], b.ts[2]).__dict__.values()):
        np.testing.assert_array_equal(x, y)
    kitti = tmp_path / "00"
    for d in ("image_0", "image_1"):
        (kitti / d).mkdir(parents=True)
        for i in range(2):
            _write_png(str(kitti / d / ("%06d.png" % i)),
                       np.full((16, 24), 40 * i + 7, np.uint8))
    (kitti / "times.txt").write_text("0.0\n0.1\n")
    same(tds.load_kitti(str(kitti)), jds.load_kitti(str(kitti)))
    tum = tmp_path / "fr1"
    (tum / "rgb").mkdir(parents=True)
    (tum / "depth").mkdir(parents=True)
    rgb_lines, dep_lines = ["# rgb"], ["# depth"]
    for i in range(3):
        t = 100.0 + 0.033 * i
        _write_png(str(tum / "rgb" / f"{t:.6f}.png"), np.full((8, 12, 3), 9 * i, np.uint8))
        _write_png(str(tum / "depth" / f"{t + 0.005:.6f}.png"),
                   np.full((8, 12), 5000 * (i + 1), np.uint16))
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        dep_lines.append(f"{t + 0.005:.6f} depth/{t + 0.005:.6f}.png")
    (tum / "rgb.txt").write_text("\n".join(rgb_lines))
    (tum / "depth.txt").write_text("\n".join(dep_lines))
    same(tds.load_tum_rgbd(str(tum)), jds.load_tum_rgbd(str(tum)))
    same(tds.load_tum_mono(str(tum)), jds.load_tum_mono(str(tum)))


# -- the twins of tests/test_system.py --


@pytest.fixture(scope="module")
def settings_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("cfg") / "stereo.yaml"
    p.write_text(YAML)
    return str(p)


@pytest.fixture(scope="module")
def seq():
    rng = np.random.default_rng(7)
    world = synthetic.make_world(rng, n_points=600, extent=7.0, depth_range=(2.5, 9.0))
    return synthetic.make_stereo_sequence(rng, n_frames=16, h=240, w=352, fx=260.0,
                                          baseline=0.2, world=world)


def small_map():
    return ms.MapConfig(max_keyframes=32, max_landmarks=4096, max_features=400, n_levels=4)


def small_tracker_cfg():
    return tracking.TrackerConfig(
        orb=orb.ORBConfig(n_features=400, n_levels=4), map=small_map(), width=352,
        height=240, max_local_lm=1024, ba_window=6, ba_fixed=2, new_lm_budget=256,
        max_frames_between_kf=4)


def system(path, vocab=None):
    return sysm.SLAMSystem(path, sysm.Sensor.STEREO, vocab=vocab, map_cfg=small_map(),
                           tracker_cfg=small_tracker_cfg(), device="cpu")


IMU_YAML = YAML + """IMU.NoiseGyro: 1.7e-04
IMU.NoiseAcc: 2.0e-03
IMU.GyroWalk: 1.9393e-05
IMU.AccWalk: 3.0e-03
IMU.Frequency: 200.0
"""


def test_determinism_enable(settings_path, monkeypatch):
    """utils.determinism.enable: sets the cuBLAS workspace when unset, refuses
    once CUDA is initialised without it or with a workspace cuBLAS does not
    run deterministically, and turns the mode on without the NaN fill of
    uninitialised memory; the facade calls it."""
    from orb_slam3_vio_fixes_tpu_torch.utils import determinism

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.utils.deterministic.fill_uninitialized_memory)
    try:
        torch.use_deterministic_algorithms(False)
        monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "is_initialized", lambda: True)
            with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
                determinism.enable()
        assert not torch.are_deterministic_algorithms_enabled()
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":0:0")
        with pytest.raises(RuntimeError, match=":0:0"):
            determinism.enable()
        monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG")
        determinism.enable()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.utils.deterministic.fill_uninitialized_memory
        torch.use_deterministic_algorithms(False)
        sysm.SLAMSystem(settings_path, sysm.Sensor.STEREO, vocab=None, device="cpu")
        assert torch.are_deterministic_algorithms_enabled()
    finally:
        torch.use_deterministic_algorithms(was[0])
        torch.utils.deterministic.fill_uninitialized_memory = was[1]


def test_settings_parse(settings_path):
    s = tset.load_settings(settings_path, sysm.Sensor.STEREO)
    assert s.cam1.fx == 260.0
    assert s.bf == 52.0
    assert s.n_features == 400


def test_sensor_dispatch_guard(settings_path, monkeypatch, tmp_path):
    slam = sysm.SLAMSystem(settings_path, sysm.Sensor.STEREO, map_cfg=small_map(),
                           device="cpu")
    assert slam.vocab.n_words == 100000 and slam.loop_closer.db.hist.shape[0] == 32
    with pytest.raises(ValueError):
        slam.track_monocular(np.zeros((240, 352)), 0.0)
    with pytest.raises(ValueError):
        slam.track_rgbd(np.zeros((240, 352)), np.zeros((240, 352)), 0.0)
    # the monocular modes: a monocular tracker, the scale free in the loop
    # closer for MONOCULAR alone and in the Atlas for both, yaw-only merges
    # for the inertial one; no stereo entry
    imu_path = tmp_path / "imu.yaml"
    imu_path.write_text(IMU_YAML)
    for sensor, kind, inertial in ((sysm.Sensor.MONOCULAR, MonocularTracker, False),
                                   (sysm.Sensor.IMU_MONOCULAR, MonoInertialTracker, True)):
        mono = sysm.SLAMSystem(str(imu_path), sensor, map_cfg=small_map(), device="cpu")
        assert type(mono.tracker) is kind and mono.tracker.bf == 0.0
        assert mono.loop_closer.cfg.fix_scale == inertial
        assert mono.loop_closer.cfg.inertial == inertial and mono.loop_closer.bf == 0.0
        assert not mono.atlas.cfg.fix_scale and mono.atlas.cfg.inertial == inertial
        with pytest.raises(ValueError):
            mono.track_stereo(np.zeros((240, 352)), np.zeros((240, 352)), 0.0)
    assert slam.atlas.cfg.fix_scale and not slam.atlas.cfg.inertial
    # a KannalaBrandt8 rig is tracked through its two camera models
    kb8 = sysm.SLAMSystem(os.path.join(CFG, "TUM-VI.yaml"), sysm.Sensor.IMU_STEREO,
                          vocab=None, device="cpu")
    assert kb8.tracker.rig is not None and kb8._rect_maps is None
    # a mesh is a parallel.Mesh with a shard on the facade's device
    with pytest.raises(TypeError):
        sysm.SLAMSystem(settings_path, sysm.Sensor.STEREO, vocab=None, mesh=object(),
                        device="cpu")
    with pytest.raises(ValueError, match="device"):
        sysm.SLAMSystem(settings_path, sysm.Sensor.STEREO, vocab=None,
                        mesh=Mesh(["meta"] * 2), device="cpu")
    # the card is the default, with no fallback when CUDA is absent
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for sensor in (sysm.Sensor.STEREO, sysm.Sensor.MONOCULAR, sysm.Sensor.IMU_MONOCULAR):
        with pytest.raises(RuntimeError, match="CUDA"):
            sysm.SLAMSystem(str(imu_path), sensor, vocab=None)


def test_system_stereo_and_snapshot(settings_path, seq, tmp_path):
    slam = system(settings_path)
    for i in range(12):
        slam.track_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
    assert slam.get_tracking_state() == tracking.TrackState.OK
    assert slam.n_keyframes() >= 2
    assert not slam.is_lost()

    # the JAX package's facade on the same frames and configuration
    ref = jsys.SLAMSystem(settings_path, JSensor.STEREO, vocab=None, map_cfg=jax_small_map(),
                          tracker_cfg=jax_small_tracker_cfg())
    for i in range(12):
        ref.track_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
    assert slam.n_keyframes() == ref.n_keyframes()
    rmse = {}
    for name, s in (("port", slam), ("jax", ref)):
        traj = s.tracker.trajectory
        rmse[name], _, n = ate.ate_rmse(seq.ts[:12], seq.t_wc[:12],
                                        np.array([x[0] for x in traj]),
                                        np.array([-R.T @ t for _, R, t in traj]))
        assert n == 12, name
    assert rmse["port"] <= 1.5 * rmse["jax"] + 0.005, rmse

    tum = str(tmp_path / "traj_tum.txt")
    slam.save_trajectory_tum(tum)
    slam.save_trajectory_euroc(str(tmp_path / "traj_euroc.txt"))
    slam.save_trajectory_kitti(str(tmp_path / "traj_kitti.txt"))
    slam.save_keyframe_trajectory_tum(str(tmp_path / "kf_tum.txt"))
    lines = open(tum).read().strip().splitlines()
    assert len(lines) == 12 and len(lines[0].split()) == 8

    # snapshot round trip with the vocabulary checksum
    q = lambda a: torch.as_tensor(np.clip(np.rint(a), 0, 255).astype(np.uint8))  # noqa: E731
    cam = slam.settings.cam1
    f0 = build_stereo_frame_impl(q(seq.imgs_l[0]), q(seq.imgs_r[0]), torch.zeros(()), cam,
                                 slam.settings.bf, slam.cfg.orb)
    vocab = voc.train(f0.desc[f0.valid].numpy(), branching=8, depth=2, seed=0)
    slam.vocab = vocab
    snap = str(tmp_path / "atlas.npz")
    slam.save_atlas(snap)

    slam2 = system(settings_path, vocab)
    slam2.load_atlas(snap)
    assert slam2.n_keyframes() == slam.n_keyframes()
    assert slam2.n_landmarks() == slam.n_landmarks()

    # localisation only: relocalise into the loaded map, no map growth
    slam2.activate_localization_mode()
    n_kf = slam2.n_keyframes()
    for i in range(12, 16):
        slam2.track_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
    assert slam2.get_tracking_state() == tracking.TrackState.OK
    assert slam2.n_keyframes() == n_kf, "localization mode must not add KFs"
    C_est = -slam2.tracker.R.numpy().T @ slam2.tracker.t.numpy()
    assert np.linalg.norm(C_est - seq.t_wc[15]) < 0.1


def test_system_monocular_modes(tmp_path):
    """MONOCULAR on tests/test_e2e_mono.py's 26 frames through
    track_monocular: state OK, >= 3 keyframes, the scale-aligned ATE under
    that test's 0.10 m, the Atlas saved and loaded back; IMU_MONOCULAR on
    the first 12 frames of tests/test_e2e_mono_inertial.py's scene: the
    two-view initialisation done, tracking OK, the IMU samples buffered
    for the initialisation."""
    path = tmp_path / "mono.yaml"
    path.write_text(IMU_YAML)
    rng = np.random.default_rng(7)
    world = synthetic.make_world(rng, n_points=600, extent=7.0, depth_range=(2.5, 9.0))
    s = synthetic.make_stereo_sequence(rng, n_frames=26, h=240, w=352, fx=260.0,
                                       baseline=0.2, world=world, speed=(0.9, 0.0, 0.15),
                                       yaw_rate=0.05)
    cfg = small_tracker_cfg()._replace(max_frames_between_kf=6)
    slam = sysm.SLAMSystem(str(path), sysm.Sensor.MONOCULAR, vocab=None, map_cfg=small_map(),
                           tracker_cfg=cfg, device="cpu")
    for i in range(26):
        slam.track_monocular(s.imgs_l[i], s.ts[i])
    assert slam.get_tracking_state() == tracking.TrackState.OK
    assert slam.n_keyframes() >= 3
    traj = slam.tracker.trajectory
    rmse, _, n = ate.ate_rmse(s.ts, s.t_wc, np.array([x[0] for x in traj]),
                              np.array([-R.T @ t for _, R, t in traj]), with_scale=True)
    assert n == 26 and rmse < 0.10, rmse
    snap = str(tmp_path / "mono.npz")
    slam.save_atlas(snap)
    slam2 = sysm.SLAMSystem(str(path), sysm.Sensor.MONOCULAR, vocab=None, map_cfg=small_map(),
                            tracker_cfg=cfg, device="cpu")
    slam2.load_atlas(snap)
    assert torch.equal(slam2.tracker.state.lm_pos, slam.tracker.state.lm_pos)
    assert slam2.tracker.kf_order == slam.tracker.kf_order

    rng = np.random.default_rng(11)
    world = synthetic.make_world(rng, n_points=700, extent=7.0, depth_range=(2.5, 9.0))
    s = synthetic.make_stereo_inertial_sequence(rng, n_frames=12, h=240, w=352, fx=260.0,
                                                baseline=0.2, world=world, imu_hz=200.0,
                                                accel_amp=0.8)
    slam = sysm.SLAMSystem(str(path), sysm.Sensor.IMU_MONOCULAR, vocab=None,
                           map_cfg=small_map(), tracker_cfg=cfg, device="cpu")
    for i in range(12):
        slam.track_monocular(s.imgs_l[i], s.ts[i],
                             s.imu[i - 1] if i > 0 else np.zeros((0, 7), np.float32))
    tr = slam.tracker
    assert slam.get_tracking_state() == tracking.TrackState.OK
    assert tr.n_kf >= 2 and 1 in tr.kf_windows and not tr.imu_ready
    assert slam.get_velocity() is not None


def test_vocab_checksum_mismatch(settings_path, seq, tmp_path):
    slam = system(settings_path)
    for i in range(6):
        slam.track_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
    rng = np.random.default_rng(0)
    pool = rng.integers(0, 2**32, size=(200, 8), dtype=np.uint32).view(np.int32)
    slam.vocab = voc.train(pool, branching=4, depth=2, seed=0)
    snap = str(tmp_path / "atlas2.npz")
    slam.save_atlas(snap)
    slam2 = system(settings_path, voc.train(pool, branching=4, depth=2, seed=1))
    with pytest.raises(Exception):
        slam2.load_atlas(snap)


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["STEREO", "RGBD", "IMU_STEREO", "IMU_RGBD", "MONOCULAR",
                                  "IMU_MONOCULAR"])
def test_jax_facade_reference_at_full_width(mode, tmp_path):
    """Where chip_smoke.JAX_FACADE_ATE_M comes from: the JAX package's
    SLAMSystem (the default 10^5-word vocabulary) from chip_smoke's YAML on
    chip_smoke's facade frames (the JAX generator), on the CPU, scored by
    chip_smoke.facade_ate. One to three minutes per mode."""
    from orb_slam3_vio_fixes_tpu import system as jsys
    from orb_slam3_vio_fixes_tpu.io import synthetic as jsyn

    import chip_smoke

    path = tmp_path / "facade.yaml"
    path.write_text(chip_smoke.FACADE_YAML)
    frames, ts, t_wc = chip_smoke.facade_scenario(mode, jsyn)
    slam = jsys.SLAMSystem(str(path), getattr(jsys.Sensor, mode))
    for a, b, t, imu in frames:
        if slam.sensor.is_rgbd:
            slam.track_rgbd(a, b, t, imu)
        elif slam.sensor.is_monocular:
            slam.track_monocular(a, t, imu)
        else:
            slam.track_stereo(a, b, t, imu)
    rmse = chip_smoke.facade_ate(mode, slam.tracker, ts, t_wc, len(frames))
    jax.clear_caches()
    print(f"jax facade {mode} at 752x480: state={slam.get_tracking_state()} ate_m={rmse!r}")
    assert slam.get_tracking_state() == "OK"
    assert abs(rmse - chip_smoke.JAX_FACADE_ATE_M[mode]) < 1e-6, rmse


# -- the facade's repairs (the JAX package keeps both faults) --


def test_imu_rgbd_undistorts(monkeypatch):
    """A distorted RGB-D camera with an IMU is undistorted before the
    inertial tracker sees the frame, as without one: the image and depth that
    reach process_rgbd_inertial equal remap_bilinear / remap_nearest of the
    inputs through the settings' map, exactly."""
    s = tset.load_settings(os.path.join(CFG, "TUM1.yaml"), sysm.Sensor.RGBD)
    s.noise_gyro, s.noise_acc, s.walk_gyro, s.walk_acc, s.imu_freq = (
        1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)
    slam = sysm.SLAMSystem(s, sysm.Sensor.IMU_RGBD, vocab=None, device="cpu")
    seen = []
    monkeypatch.setattr(slam.tracker, "process_rgbd_inertial",
                        lambda img, depth, ts, imu: seen.append((img, depth)))
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (480, 640)).astype(np.uint8)
    depth = rng.uniform(0.5, 4.0, (480, 640)).astype(np.float32)
    slam.track_rgbd(img, depth, 0.0, np.zeros((0, 7), np.float32))
    m = torch.as_tensor(s.undist_map)
    got_img, got_depth = seen[0]
    assert isinstance(got_img, torch.Tensor) and isinstance(got_depth, torch.Tensor)
    assert torch.equal(got_img, trec.remap_bilinear(torch.as_tensor(img, dtype=torch.float32), m))
    assert torch.equal(got_depth, trec.remap_nearest(torch.as_tensor(depth), m))


def test_imu_stereo_atlas_load_resets_inertial_state(tmp_path):
    """load_atlas on an IMU sensor drops the IMU state, which the snapshot
    does not hold (the previous map's IMU windows would name the loaded
    map's keyframe slots): right after the load the IMU is not initialised
    and no window is left. The next frames relocalise into the loaded map
    and the IMU initialises anew on it. The scene is test_e2e_inertial's
    (352x240, IMU at 200 Hz), a keyframe at least every 4 frames; IMU
    initialisation after 4 keyframes and 0.5 s as in the stereo-inertial
    twins. Bars: OK within 3 frames of the load, OK with the IMU initialised
    again at frame 36, ATE over all 36 frames under 0.05 m."""
    from test_torch_rgbd import IMU_YAML

    rng = np.random.default_rng(5)
    world = synthetic.make_world(rng, n_points=600, extent=7.0, depth_range=(2.5, 9.0))
    n = 36
    s = synthetic.make_stereo_inertial_sequence(rng, n_frames=n, h=240, w=352, fx=260.0,
                                                baseline=0.2, world=world, imu_hz=200.0,
                                                accel_amp=0.6)
    img0 = torch.as_tensor(np.clip(np.rint(s.imgs_l[0]), 0, 255).astype(np.float32))
    f0 = orb.extract_batch(img0[None], orb.ORBConfig(n_features=400, n_levels=4))
    vocab = voc.train(f0.desc[0][f0.valid[0]].numpy(), branching=8, depth=2, seed=0)
    path = tmp_path / "imu_stereo.yaml"
    path.write_text(IMU_YAML)
    slam = sysm.SLAMSystem(str(path), sysm.Sensor.IMU_STEREO, vocab=vocab,
                           map_cfg=small_map(), tracker_cfg=small_tracker_cfg(),
                           device="cpu")
    tr = slam.tracker
    tr.icfg = tr.icfg._replace(init_min_kfs=4, init_min_time=0.5)

    def track(i):
        imu = s.imu[i - 1] if i > 0 else np.zeros((0, 7), np.float32)
        slam.track_stereo(s.imgs_l[i], s.imgs_r[i], s.ts[i], imu)

    i = 0
    while not tr.imu_ready:
        track(i)
        i += 1
        assert i < 24, "the IMU never initialised"
    # a few frames more: the loop closer's database holds only keyframes
    # made after the IMU initialisation
    for i in range(i, i + 4):
        track(i)
    i += 1
    snap = str(tmp_path / "atlas.npz")
    slam.save_atlas(snap)
    n_kf = slam.n_keyframes()
    slam.load_atlas(snap)
    assert not tr.imu_ready and tr.kf_windows == {} and tr.body is None
    assert slam.n_keyframes() == n_kf and slam.get_tracking_state() == tracking.TrackState.LOST
    states = []
    for i in range(i, n):
        track(i)
        states.append(slam.get_tracking_state())
    assert tracking.TrackState.OK in states[:3], states
    assert states[-1] == tracking.TrackState.OK and tr.imu_ready, states
    traj = tr.trajectory
    rmse, _, m = ate.ate_rmse(s.ts, s.t_wc, np.array([x[0] for x in traj]),
                              np.array([-R.T @ t for _, R, t in traj]))
    assert m == n and rmse < 0.05, rmse
