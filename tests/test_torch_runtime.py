"""The port's host runtime (orb_slam3_vio_fixes_tpu_torch/runtime) against the
JAX package's: the twins of tests/test_runtime.py.

Tolerances:
- the native library builds from native/orbslam3_tpu_rt.cpp into the port's
  build/native/ tree (not into native/);
- the queue: FIFO order, reject-when-full, drop-oldest and a cross-thread
  hand-off, exact; the numpy fallback behaves the same;
- hamming_match / hamming_matrix exactly equal to the reference's and to the
  numpy twins (ties to the lowest index);
- StageTimes: the summary's means within 1e-6 relative;
- the runner's decoder -> tracker hand-off under a 1 us switch interval:
  every frame once and in order, native queue and list alike;
- PipelineRunner over a 5-frame 352x240 EuRoC-layout directory on the CPU
  with a loopback MAVLinkInterface: state OK, every frame tracked, the
  native queue used, one CRC-valid ODOMETRY per frame that had a pose, the
  last one the tracker's final pose in NED within 1e-5.
"""

import struct
import sys
import threading
import types

import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu.runtime import native as jnat
from orb_slam3_vio_fixes_tpu_torch import runtime as rt
from orb_slam3_vio_fixes_tpu_torch import system as sysm
from orb_slam3_vio_fixes_tpu_torch import vio
from orb_slam3_vio_fixes_tpu_torch.frontend import tracking
from orb_slam3_vio_fixes_tpu_torch.io import datasets, synthetic
from orb_slam3_vio_fixes_tpu_torch.ops import orb
from orb_slam3_vio_fixes_tpu_torch.runtime import native as tnat
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms

from test_apps import SETTINGS_YAML

pytest_plugins = ["torch_jax_release"]
# every thread a test starts (shards, decoder, interface loops) ends with it
pytestmark = pytest.mark.usefixtures("threads_end")

torch.set_num_threads(2)


def test_native_library_builds_into_build_tree():
    assert rt.native_available()
    so = tnat.library_path()
    assert so.exists() and so.parent == tnat.BUILD_DIR
    assert so.parent.parts[-2:] == ("build", "native")


@pytest.fixture(params=["native", "numpy"])
def queue_kind(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(tnat, "_try_load", lambda: None)
    return request.param


def test_queue_semantics(queue_kind):
    q = rt.NativeQueue(capacity=3, item_size=8, drop_oldest=False)
    assert (q._q is not None) == (queue_kind == "native")
    for i in range(3):
        assert q.push(struct.pack("<q", i))
    assert not q.push(struct.pack("<q", 99))       # full: reject (keyframe queue)
    assert q.size() == 3
    assert [struct.unpack("<q", q.pop())[0] for _ in range(3)] == [0, 1, 2]
    assert q.pop(timeout_ms=10) is None
    with pytest.raises(ValueError):
        q.push(b"short")

    q = rt.NativeQueue(capacity=2, item_size=8, drop_oldest=True)
    for i in range(4):
        assert q.push(struct.pack("<q", i))
    assert [struct.unpack("<q", q.pop())[0] for _ in range(2)] == [2, 3]

    q = rt.NativeQueue(capacity=16, item_size=4)
    got = []

    def consumer():
        while True:
            item = q.pop(timeout_ms=2000)
            if item is None or struct.unpack("<i", item)[0] < 0:
                return
            got.append(struct.unpack("<i", item)[0])

    t = threading.Thread(target=consumer)
    t.start()
    for i in range(200):
        while not q.push(struct.pack("<i", i)):
            pass
    q.push(struct.pack("<i", -1))
    t.join(timeout=10)
    assert not t.is_alive() and got == list(range(200))


@pytest.mark.parametrize("nq,nd", [(17, 41), (64, 300), (1, 1), (0, 5), (5, 0)])
def test_hamming_matches_reference(nq, nd):
    rng = np.random.default_rng(nq * 1000 + nd)
    q = rng.integers(0, 256, size=(nq, 32), dtype=np.uint8)
    db = rng.integers(0, 256, size=(nd, 32), dtype=np.uint8)
    if nq and nd > 2:
        db[2] = db[0]               # a tie for every query
    got = rt.hamming_match(q, db)
    if nq and nd:
        # the reference's library (empty inputs take its numpy fallback)
        for a, b in zip(got, jnat.hamming_match(q, db)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(rt.hamming_matrix(q, db), jnat.hamming_matrix(q, db))
    for a, b in zip(got, tnat.hamming_match_plain(q, db)):
        np.testing.assert_array_equal(a, b)
    mat = tnat.hamming_matrix_plain(q, db)
    assert mat.shape == (nq, nd)
    np.testing.assert_array_equal(rt.hamming_matrix(q, db), mat)
    if nq and nd:
        np.testing.assert_array_equal(got[0], mat.argmin(1))
        np.testing.assert_array_equal(got[1], mat.min(1))


def test_stage_times_report(tmp_path):
    st = rt.StageTimes()
    for v in (0.01, 0.02, 0.03):
        st.add("track", v)
    with st.scope("decode"):
        pass
    s = st.summary()
    assert s["track"]["count"] == 3 and s["decode"]["count"] == 1
    assert s["track"]["mean_ms"] == pytest.approx(20.0, rel=1e-6)
    p = tmp_path / "ExecMean.txt"
    st.save(str(p))
    lines = p.read_text().splitlines()
    assert lines[0] == "stage, mean_ms, std_ms, count"
    assert lines[1].startswith("decode, ") and lines[2] == "track, 20.000, 8.165, 3"


class FakeSeq:
    """A sequence of tiny frames whose pixels carry the frame index."""

    imu = None

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def frame(self, i):
        return 0.05 * i, np.full((4, 6), i, np.float32), np.full((4, 6), -i, np.float32), None


class FakeSystem:
    """Records what the runner hands the facade."""

    sensor = sysm.Sensor.STEREO

    def __init__(self):
        self.got = []
        self.tracker = types.SimpleNamespace(traj=[], trajectory=[])

    def track_stereo(self, im_l, im_r, ts, imu=None):
        self.got.append((ts, int(im_l[0, 0]), int(im_r[0, 0])))


@pytest.mark.parametrize("prefetch", [1, 3])
def test_pipeline_runner_hand_off_stress(queue_kind, prefetch):
    """The decoder thread and the tracking thread under a 1 us switch
    interval: every frame arrives once, in order, through the bounded
    hand-off (native queue or list), and the decoder thread ends."""
    n = 300
    slam = FakeSystem()
    runner = rt.PipelineRunner(slam, FakeSeq(n), prefetch=prefetch)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        res = runner.run()
    finally:
        sys.setswitchinterval(old)
    assert runner.used_native_queue == (queue_kind == "native")
    assert slam.got == [(0.05 * i, i, -i) for i in range(n)]
    assert res.n_frames == n and len(res.times.series["decode"]) == n
    assert not any(t.name == "frame-decoder" and t.is_alive() for t in threading.enumerate())


def write_euroc(root, imgs_l, imgs_r, t0_ns=10**9, dt_ns=5 * 10**7):
    """Write a stereo sequence as a EuRoC mav0 directory of PNGs."""
    from PIL import Image

    for cam in ("cam0", "cam1"):
        (root / "mav0" / cam / "data").mkdir(parents=True)
    for i in range(len(imgs_l)):
        for cam, im in (("cam0", imgs_l[i]), ("cam1", imgs_r[i])):
            Image.fromarray(np.clip(np.rint(im), 0, 255).astype(np.uint8)).save(
                str(root / "mav0" / cam / "data" / f"{t0_ns + i * dt_ns}.png"))


def small_configs():
    map_cfg = ms.MapConfig(max_keyframes=8, max_landmarks=2048, max_features=320,
                           n_levels=4)
    return map_cfg, tracking.TrackerConfig(
        orb=orb.ORBConfig(n_features=320, n_levels=4), map=map_cfg, width=352,
        height=240, max_local_lm=512, ba_window=4, ba_fixed=2, new_lm_budget=128,
        max_frames_between_kf=6)


def test_pipeline_runner_with_mavlink(tmp_path):
    rng = np.random.default_rng(7)
    world = synthetic.make_world(rng, n_points=600, extent=7.0, depth_range=(2.5, 9.0))
    s = synthetic.make_stereo_sequence(rng, n_frames=5, h=240, w=352, fx=260.0,
                                       baseline=0.2, world=world)
    write_euroc(tmp_path / "seq", s.imgs_l, s.imgs_r)
    seq = datasets.load_euroc(str(tmp_path / "seq"), with_imu=False)
    yaml_path = tmp_path / "settings.yaml"
    yaml_path.write_text(SETTINGS_YAML.format(
        fx=float(s.K[0, 0]), fy=float(s.K[1, 1]), cx=float(s.K[0, 2]),
        cy=float(s.K[1, 2]), w=352, h=240, bf=float(s.K[0, 0] * s.baseline)))
    map_cfg, tracker_cfg = small_configs()
    slam = sysm.SLAMSystem(str(yaml_path), sysm.Sensor.STEREO, vocab=None, map_cfg=map_cfg,
                           tracker_cfg=tracker_cfg, device="cpu")
    tp = vio.LoopbackTransport()
    link = vio.MAVLinkInterface(tp, mode=vio.TxMode.ODOMETRY)
    runner = rt.PipelineRunner(slam, seq, prefetch=2, mavlink=link)
    res = runner.run()
    link.drain()
    assert runner.used_native_queue
    assert res.n_frames == 5 and len(res.trajectory) == 5
    assert set(res.times.series) == {"decode", "track"}
    assert slam.get_tracking_state() == tracking.TrackState.OK
    frames = vio.parse_frames(bytes(tp.buffer))
    assert [f["msgid"] for f in frames] == [vio.mavlink.MSG_ODOMETRY] * 5
    assert all(f["crc_ok"] for f in frames)
    R_cw, t_cw = slam.tracker.R.numpy(), slam.tracker.t.numpy()
    ned = vio.camera_to_ned(R_cw.T, -R_cw.T @ t_cw)
    last = struct.unpack("<7f", frames[-1]["payload"][8:36])
    np.testing.assert_allclose(last, np.concatenate([ned["pos"], ned["quat"]]), atol=1e-5)
