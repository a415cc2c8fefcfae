"""The port's tracer (runtime/tracing.py) and the spans and counters the
program makes with it.

- With no tracer installed, `span` returns the one shared no-op context,
  `count` and `job` do nothing, and no clock, profiler or sync debug mode
  is touched, through a facade's set-up and frames too.
- Nested spans carry their parent, frame and cause (a keyframe job run
  later carries the frame that made it); self time is the duration minus
  the children's; each duration also lands in StageTimes' series.
- Under a CPU torch.profiler run, each exported span lies within 1 ms of a
  profiler range opened just inside it, on the profiler's clock.
- Tiny stereo and stereo-inertial runs of SLAMSystem.track_stereo (the
  io/synthetic scenes of the facade tests) record every span of
  tracing.SPANS their path reaches and no name outside it, and their
  `track_stereo` spans cover the loop's wall time within 5%.
"""

import contextlib
import time

import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu_torch import system as sysm
from orb_slam3_vio_fixes_tpu_torch.frontend import tracking
from orb_slam3_vio_fixes_tpu_torch.io import synthetic
from orb_slam3_vio_fixes_tpu_torch.ops import orb
from orb_slam3_vio_fixes_tpu_torch.runtime import StageTimes, tracing
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms
from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary as voc

torch.set_num_threads(2)

YAML = """
File.version: "1.0"
Camera.type: "Rectified"
Camera1.fx: 260.0
Camera1.fy: 260.0
Camera1.cx: 176.0
Camera1.cy: 120.0
Camera.width: 352
Camera.height: 240
Camera.fps: 20
Camera.RGB: 1
Camera.bf: 52.0
Stereo.ThDepth: 35.0
ORBextractor.nFeatures: 400
ORBextractor.nLevels: 4
ORBextractor.scaleFactor: 1.2
"""
IMU_YAML = YAML + """IMU.NoiseGyro: 1.7e-04
IMU.NoiseAcc: 2.0e-03
IMU.GyroWalk: 1.9393e-05
IMU.AccWalk: 3.0e-03
IMU.Frequency: 200.0
"""


def small_map():
    return ms.MapConfig(max_keyframes=32, max_landmarks=4096, max_features=400, n_levels=4)


def small_tracker_cfg():
    return tracking.TrackerConfig(
        orb=orb.ORBConfig(n_features=400, n_levels=4), map=small_map(), width=352,
        height=240, max_local_lm=1024, ba_window=6, ba_fixed=2, new_lm_budget=256,
        max_frames_between_kf=4)


def vocab_of(img):
    img = torch.as_tensor(np.clip(np.rint(img), 0, 255).astype(np.float32))
    f0 = orb.extract_batch(img[None], orb.ORBConfig(n_features=400, n_levels=4))
    return voc.train(f0.desc[0][f0.valid[0]].numpy(), branching=8, depth=2, seed=0,
                     device="cpu")


class Untouchable:
    """Stands in for a module the off path must not use."""

    def __init__(self, what):
        self.what = what

    def __getattr__(self, name):
        raise AssertionError(f"{self.what}.{name} used with no tracer installed")


def test_off_path_records_nothing(tmp_path, monkeypatch):
    assert tracing.current() is None
    assert tracing.span("track_step") is tracing.NO_SPAN
    assert tracing.span("track_stereo", root=True) is tracing.NO_SPAN
    with tracing.span("x") as s:
        assert s is tracing.NO_SPAN
    fn = object()
    assert tracing.job(fn) is fn
    tracing.count("loop.candidates")
    # a facade's set-up and frames: no clock read, no profiler, no sync
    # debug mode (set only where a tracer counts syncs)
    path = tmp_path / "stereo.yaml"
    path.write_text(YAML)
    rng = np.random.default_rng(7)
    world = synthetic.make_world(rng, n_points=300, extent=7.0, depth_range=(2.5, 9.0))
    seq = synthetic.make_stereo_sequence(rng, n_frames=2, h=240, w=352, fx=260.0,
                                         baseline=0.2, world=world)
    monkeypatch.setattr(tracing, "time", Untouchable("time"))
    modes = []
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    slam = sysm.SLAMSystem(str(path), sysm.Sensor.STEREO, vocab=None, map_cfg=small_map(),
                           tracker_cfg=small_tracker_cfg(), device="cpu")
    assert tracing.current() is None
    # (deterministic mode's imports touch the profiler's names)
    monkeypatch.setattr(tracing.torch, "profiler", Untouchable("torch.profiler"))
    for i in range(2):
        slam.track_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
    assert modes == []
    monkeypatch.undo()
    # where CUDA is missing a tracer counts no syncs and leaves the mode be
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    with tracing.traced(tracing.Tracer(), syncs=True):
        pass
    assert modes == [] and tracing.current() is None


def test_nested_spans_parent_frame_cause_and_self_time():
    def kf_job():
        with tracing.span("kf_local_ba"):
            time.sleep(0.001)

    tr = tracing.Tracer()
    assert isinstance(tr, StageTimes)
    with tracing.traced(tr):
        assert tracing.current() is tr
        with tracing.span("track_stereo", root=True):
            with tracing.span("frame_build"):
                time.sleep(0.002)
            with tracing.span("track_step"):
                with tracing.span("match.retry.wait"):
                    time.sleep(0.002)
            later = tracing.job(kf_job)
            tracing.count("loop.candidates")
        with tracing.span("track_stereo", root=True):
            later()
            tracing.count("loop.candidates", 2)
    assert tracing.current() is None
    ex = tr.export()
    by = {}
    for s in ex["spans"]:
        by.setdefault(s["name"], []).append(s)
    ids = {s["id"]: s for s in ex["spans"]}
    assert ex["frames"] == 2 and len(by["track_stereo"]) == 2
    root0, root1 = by["track_stereo"]
    assert root0["parent"] == -1 and root0["frame"] == 0 and root1["frame"] == 1
    assert ids[by["match.retry.wait"][0]["parent"]]["name"] == "track_step"
    assert by["frame_build"][0]["parent"] == root0["id"]
    job = by["kf_local_ba"][0]
    assert job["frame"] == 1 and job["cause"] == 0 and job["parent"] == root1["id"]
    assert by["frame_build"][0]["cause"] == 0
    # self time: the duration minus the children's
    kids = sum(s["end_ns"] - s["start_ns"] for s in ex["spans"] if s["parent"] == root0["id"])
    assert root0["self_ns"] == root0["end_ns"] - root0["start_ns"] - kids
    assert by["frame_build"][0]["self_ns"] == (by["frame_build"][0]["end_ns"]
                                              - by["frame_build"][0]["start_ns"])
    assert ex["counters"] == {"loop.candidates": 3}
    assert ex["syncs"]["track_step"] == 0 and ex["syncs_outside"] == 0
    assert set(ex["launches"]) == {"fast_score", "hamming_match", "hamming_match_cols"}
    # StageTimes' series and report cover every span
    assert len(tr.series["track_stereo"]) == 2
    assert tr.series["frame_build"][0] == pytest.approx(
        (by["frame_build"][0]["end_ns"] - by["frame_build"][0]["start_ns"]) / 1e9)
    assert "match.retry.wait, " in tr.report()
    assert any(ln.startswith("track_stereo") for ln in tracing.table(ex))


def test_spans_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    @contextlib.contextmanager
    def probed(name, root=False):
        # a profiler range of the test's own, just inside the span
        with tracing.span(name, root=root), torch.profiler.record_function("probe: " + name):
            yield

    tr = tracing.Tracer()
    with tracing.traced(tr), profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with probed("track_stereo", root=True):
                with probed("frame_build"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
                    time.sleep(0.003)
    start = prof.profiler.kineto_results.trace_start_ns()
    ranges = [(e.name[len("probe: "):], start + 1e3 * e.time_range.start,
               start + 1e3 * e.time_range.end)
              for e in prof.events() if e.name.startswith("probe: ")]
    spans = tr.export()["spans"]
    assert len(ranges) == len(spans) == 6
    for s in spans:
        near = [r for r in ranges if r[0] == s["name"]
                and abs(r[1] - s["start_ns"]) < 1e6 and abs(r[2] - s["end_ns"]) < 1e6]
        assert near, s


def _run(sensor, tmp_path):
    """A tiny run through the facade under a tracer: (tracer, the loop's wall
    seconds, the tracker)."""
    rng = np.random.default_rng(5 if sensor == sysm.Sensor.IMU_STEREO else 7)
    world = synthetic.make_world(rng, n_points=600, extent=7.0, depth_range=(2.5, 9.0))
    path = tmp_path / "cfg.yaml"
    tr = tracing.Tracer()
    if sensor == sysm.Sensor.IMU_STEREO:
        s = synthetic.make_stereo_inertial_sequence(rng, n_frames=24, h=240, w=352,
                                                    fx=260.0, baseline=0.2, world=world,
                                                    imu_hz=200.0, accel_amp=0.6)
        path.write_text(IMU_YAML)
    else:
        s = synthetic.make_stereo_sequence(rng, n_frames=16, h=240, w=352, fx=260.0,
                                           baseline=0.2, world=world)
        path.write_text(YAML)
    with tracing.traced(tr):
        slam = sysm.SLAMSystem(str(path), sensor, vocab=vocab_of(s.imgs_l[0]),
                               map_cfg=small_map(), tracker_cfg=small_tracker_cfg(),
                               device="cpu")
        trk = slam.tracker
        if sensor == sysm.Sensor.IMU_STEREO:
            trk.icfg = trk.icfg._replace(init_min_kfs=4, init_min_time=0.5)
        t0 = time.perf_counter()
        for i in range(len(s.ts)):
            imu = None
            if sensor == sysm.Sensor.IMU_STEREO:
                imu = s.imu[i - 1] if i > 0 else np.zeros((0, 7), np.float32)
            slam.track_stereo(s.imgs_l[i], s.imgs_r[i], s.ts[i], imu)
        wall = time.perf_counter() - t0
    return tr, wall, trk


@pytest.mark.parametrize("sensor, reached", [
    ("STEREO", {"track_step", "kf_local_ba", "kf_cull"}),
    ("IMU_STEREO", {"track_step", "vi_track_step", "vi_track_step.preintegrate",
                    "vi_track_step.match", "vi_track_step.opt",
                    "vi_track_step.local_map_search", "vi_local_ba", "imu_init"}),
])
def test_facade_run_records_the_table(sensor, reached, tmp_path):
    tr, wall, trk = _run(sysm.Sensor[sensor], tmp_path)
    ex = tr.export()
    names = {s["name"] for s in ex["spans"]}
    assert names <= set(tracing.SPANS), names - set(tracing.SPANS)
    assert set(ex["counters"]) <= set(tracing.COUNTERS)
    common = {"facade", "facade.determinism", "track_stereo", "frame_build",
              "frame_build.upload", "track.pull.wait", "record.wait", "kf_create_map",
              "kf_finalize", "kf_finalize.wait", "loop", "loop.query",
              "loop.candidates.wait"}
    assert common | reached <= names, (common | reached) - names
    assert trk.track_state == tracking.TrackState.OK
    # one root span per facade call, every other span inside one
    roots = [s for s in ex["spans"] if s["name"] == "track_stereo"]
    assert ex["frames"] == len(roots) == len(trk.traj)
    assert all(s["parent"] >= 0 for s in ex["spans"]
               if s["name"] not in ("track_stereo", "facade"))
    assert "loop.candidates" in ex["counters"]
    covered = sum(s["end_ns"] - s["start_ns"] for s in roots) / 1e9
    assert covered == pytest.approx(wall, rel=0.05)
