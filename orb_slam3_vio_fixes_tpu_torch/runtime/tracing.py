"""The port's tracer: named spans and counters at the layer boundaries of
the program, recorded by the code that does the work.

`StageTimes` (the REGISTER_TIMES analogue of the reference: named duration
series with a mean/std report, include/Settings.h:24, src/Tracking.cc:263-352)
is the base. `Tracer` grows it with spans (name, parent span, the facade
call's index as the frame, the frame a deferred keyframe job was made by as
its cause, start and end in ns, the stream synchronisations made inside),
self times, counters, and an `export()` of plain lists and dicts.

The program calls the module functions `span(name)` and `count(name)`. They
act on the tracer installed with `traced(...)`; with none installed, `span`
returns one shared no-op context and `count` returns at once: no clock read,
no allocation, no sync. Every span and counter the program makes is named in
`SPANS` and `COUNTERS` below, with what reads it. Work that a span already
marks is counted by its calls (keyframes are `kf_create_map` calls, loop
verifications `loop.verify` calls); counters count what no span marks.

Clocks: spans are stamped with `time.perf_counter_ns()` and exported on the
profiler's clock (`time.time_ns()`'s epoch, on which Kineto stamps host and
device events as its trace start plus each event's offset) through one
anchor pair read at the first install, so a torch.profiler run's device
events can be placed in the program's spans without any range of its own.

With `traced(tracer, syncs=True)` on a machine with CUDA, torch.cuda's sync
debug mode reports every stream synchronisation, and the tracer adds each to
the innermost open span of its thread (the synchronisations by site). Both
the mode and the warning filters are restored on exit.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import warnings
from typing import Dict, List

import numpy as np
import torch

# Every span the program opens: name -> (what it covers, what reads it).
# The readers are the readouts of `python -m slam_bench.program`: its
# `[program]` table (every span and counter) and its `[program] layers` rows.
# Names ending in ".wait" are host reads of device results: the host waits
# there for the device to finish the work queued before the read.
SPANS = {
    "track_stereo": ("one SLAMSystem.track_stereo call; each opens a new frame",
                     "layers: the frames of wait_ms_per_frame, retry_share"),
    "frame_build": ("StereoTracker._build_stereo: the pair's upload and the stereo "
                    "frame build (pyramid, K1, ORB, stereo K2, SAD)", "layers: frame_build_ms"),
    "frame_build.upload": ("the pair's host-to-device copy", "[program] table"),
    "track_step": ("the visual tracking step, track_step_impl, as dispatched",
                   "layers: track_step_ms"),
    "track_ref_kf": ("the reference-keyframe fallback (both trackers)",
                     "layers: retry_share"),
    "vi_track_step": ("the visual-inertial tracking step", "layers: vi_track_step_ms"),
    "vi_track_step.preintegrate": ("the frame's preintegration and state prediction",
                                   "[program] table"),
    "vi_track_step.match": ("the motion-model match with its wide-radius retry",
                            "[program] table"),
    "vi_track_step.opt": ("each of the two vi_motion_opt solves", "[program] table"),
    "vi_track_step.local_map_search": ("the local-map projection search", "[program] table"),
    "kf_create_map": ("keyframe insertion, spawning, triangulation and fusion; one per "
                      "keyframe", "layers: kf_stages_ms_per_kf and the keyframes of "
                      "loop_ms_per_kf, verifications_per_kf"),
    "kf_local_ba": ("the visual local BA of a keyframe", "layers: kf_stages_ms_per_kf"),
    "kf_cull": ("landmark and keyframe culling of a keyframe", "layers: kf_stages_ms_per_kf"),
    "kf_finalize": ("loop closing, the keyframe's bookkeeping pull and the Atlas merge",
                    "[program] table"),
    "vi_local_ba": ("the inertial window BA", "layers: vi_local_ba_ms"),
    "loop": ("StereoTracker._kf_stage_loop: LoopCloser.on_keyframe, and after a "
             "correction the seam fuse, welding BA and post-loop hook",
             "layers: loop_ms_per_kf"),
    "loop.query": ("the keyframe's BoW histogram, database entry and retrieval",
                   "[program] table"),
    "loop.verify": ("one candidate's Sim3 verification and gate pull",
                    "layers: verifications_per_kf"),
    "loop.correct": ("the pose graph, landmark correction and global BA of a correction",
                     "[program] table"),
    "imu_init": ("the IMU initialisation with its window and full-map VI BA",
                 "[program] table"),
    "reloc": ("one relocalisation attempt", "[program] table"),
    "facade": ("SLAMSystem's set-up", "layers: facade_s"),
    "facade.determinism": ("utils.determinism.enable", "[program] table"),
    "facade.vocabulary": ("reading the default vocabulary onto the device",
                          "[program] table"),
    "kernels.build": ("the CUDA kernels' nvcc build (when missing) and load",
                      "[program] table"),
    "track.pull.wait": ("the decision vector's pull after a tracking step",
                        "layers: wait_ms_per_frame"),
    "match.retry.wait": ("the synced match count that decides the wide-radius retry",
                         "layers: wait_ms_per_frame"),
    "track_ref_kf.wait": ("the fallback's decision vector pull", "layers: wait_ms_per_frame"),
    "record.wait": ("the pose pulls of StereoTracker._record and the pose returned "
                    "after a keyframe rebased the tracker", "layers: wait_ms_per_frame"),
    "kf_finalize.wait": ("the keyframe's bookkeeping scalars and pose",
                         "layers: wait_ms_per_frame"),
    "kf_cull.wait": ("the redundancy mask, covisibility rows and poses of keyframe culling",
                     "layers: wait_ms_per_frame"),
    "loop.candidates.wait": ("the retrieval's candidate slots", "layers: wait_ms_per_frame"),
    "loop.gates.wait": ("one candidate's gate scalars", "layers: wait_ms_per_frame"),
    "loop.covis.wait": ("the loop candidate's covisibility row", "layers: wait_ms_per_frame"),
}

# Every counter: name -> (what it counts, what reads it).
COUNTERS = {
    "match.wide_retries": ("motion-model matches retried with the wide radius",
                           "layers: retry_share"),
    "loop.candidates": ("loop candidates retrieved", "[program] table"),
    "imu.rows_integrated": ("rows of the IMU sample blocks handed to preintegration, one "
                            "step each (inertial_tracking.pack_imu)", "[program] table"),
    "imu.rows_skipped": ("the blocks' capacity rows left out as zero padding past the "
                         "longest real window", "[program] table"),
}


class StageTimes:
    """REGISTER_TIMES analogue: named per-stage duration series."""

    def __init__(self):
        self.series: Dict[str, List[float]] = {}

    def add(self, stage: str, seconds: float) -> None:
        self.series.setdefault(stage, []).append(seconds)

    class _Scope:
        def __init__(self, st: "StageTimes", stage: str):
            self.st, self.stage = st, stage

        def __enter__(self):
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            self.st.add(self.stage, time.perf_counter() - self.t0)

    def scope(self, stage: str) -> "_Scope":
        return self._Scope(self, stage)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for k, v in self.series.items():
            a = np.asarray(v)
            out[k] = {
                "mean_ms": float(a.mean() * 1e3),
                "std_ms": float(a.std() * 1e3),
                "count": int(a.size),
            }
        return out

    def report(self) -> str:
        """ExecMean.txt-style report (src/Tracking.cc:263-352)."""
        lines = ["stage, mean_ms, std_ms, count"]
        for k, s in sorted(self.summary().items()):
            lines.append(
                f"{k}, {s['mean_ms']:.3f}, {s['std_ms']:.3f}, {s['count']}"
            )
        return "\n".join(lines)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.report() + "\n")


class Tracer(StageTimes):
    """StageTimes with spans and counters. Each span's duration is also
    appended to `series[name]`, so `summary` and `report` cover every
    span."""

    def __init__(self):
        super().__init__()
        # (id, name, parent id, frame, cause, t0_ns, t1_ns, syncs), at exit
        self.records: list = []
        self.counters: Dict[str, int] = {}
        self.frame = -1             # the facade call in progress
        self.cause = None           # the frame a running keyframe job belongs to
        self.syncs_outside = 0      # synchronisations outside every span
        self.anchor = None          # (time.time_ns(), time.perf_counter_ns())
        self._launches0 = None
        self._ids = itertools.count()
        self._local = threading.local()

    def _stack(self) -> list:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def start(self) -> None:
        """The clock anchor and the launch counters' baseline (first call
        only)."""
        if self.anchor is None:
            self.anchor = (time.time_ns(), time.perf_counter_ns())
            self._launches0 = _launch_counts()

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def synced(self) -> None:
        stack = self._stack()
        if stack:
            stack[-1].syncs += 1
        else:
            self.syncs_outside += 1

    def export(self) -> dict:
        """Spans (ordered by when they opened; times on the profiler's
        clock, ns; self time = duration minus the part its child spans
        cover), counters, synchronisations per span name, and the change of
        kernels.launch_counts()."""
        off = self.anchor[0] - self.anchor[1] if self.anchor else 0
        child = {}
        for _, _, parent, _, _, t0, t1, _ in self.records:
            if parent >= 0:
                child[parent] = child.get(parent, 0) + (t1 - t0)
        spans, syncs = [], {}
        for sid, name, parent, frame, cause, t0, t1, ns in sorted(self.records):
            spans.append({"id": sid, "name": name, "parent": parent, "frame": frame,
                          "cause": cause, "start_ns": t0 + off, "end_ns": t1 + off,
                          "self_ns": t1 - t0 - child.get(sid, 0), "syncs": ns})
            syncs[name] = syncs.get(name, 0) + ns
        now = _launch_counts()
        base = self._launches0 or {}
        return {"frames": self.frame + 1, "spans": spans, "counters": dict(self.counters),
                "syncs": syncs, "syncs_outside": self.syncs_outside,
                "launches": {k: v - base.get(k, 0) for k, v in now.items()},
                "anchor": {"time_ns": self.anchor[0], "perf_counter_ns": self.anchor[1]}
                if self.anchor else None}


def _launch_counts() -> dict:
    # kernels imports this module
    from orb_slam3_vio_fixes_tpu_torch import kernels

    return kernels.launch_counts()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("tr", "name", "root", "id", "parent", "frame", "cause", "t0", "syncs",
                 "stack")

    def __init__(self, tr: Tracer, name: str, root: bool):
        self.tr, self.name, self.root = tr, name, root

    def __enter__(self):
        tr = self.tr
        if self.root:
            tr.frame += 1
        stack = self.stack = tr._stack()
        self.parent = stack[-1].id if stack else -1
        self.id = next(tr._ids)
        self.frame = tr.frame
        self.cause = tr.cause if tr.cause is not None else tr.frame
        self.syncs = 0
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.stack.pop()
        tr = self.tr
        tr.records.append((self.id, self.name, self.parent, self.frame, self.cause,
                           self.t0, t1, self.syncs))
        tr.add(self.name, (t1 - self.t0) / 1e9)
        return False


_TRACER = None


def current():
    """The installed tracer, or None."""
    return _TRACER


def span(name: str, root: bool = False):
    """A context that records span `name` in the installed tracer; `root`
    opens a new frame. With no tracer installed, the shared no-op."""
    tr = _TRACER
    if tr is None:
        return NO_SPAN
    return _Span(tr, name, root)


def count(name: str, n: int = 1) -> None:
    tr = _TRACER
    if tr is not None:
        tr.count(name, n)


def job(fn):
    """`fn`, to run later as a job of the frame in progress: the spans it
    opens carry that frame as their cause. `fn` itself with no tracer."""
    tr = _TRACER
    if tr is None:
        return fn
    frame = tr.frame

    def run(*a, **k):
        prev, tr.cause = tr.cause, frame
        try:
            return fn(*a, **k)
        finally:
            tr.cause = prev
    return run


@contextlib.contextmanager
def _counting_syncs(tr: Tracer):
    """torch.cuda's sync debug mode on, each synchronisation it reports
    added to the innermost open span; other warnings pass on."""
    prev_mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=".*synchroniz")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" in str(message):
                tr.synced()
                return
            shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev_mode)


@contextlib.contextmanager
def traced(tracer: Tracer, syncs: bool = False):
    """Install `tracer` while the context lasts (the one installed before
    comes back after). With `syncs`, and only where CUDA is available, count
    the stream synchronisations by span."""
    global _TRACER
    tracer.start()
    prev, _TRACER = _TRACER, tracer
    try:
        if syncs and torch.cuda.is_available():
            with _counting_syncs(tracer):
                yield tracer
        else:
            yield tracer
    finally:
        _TRACER = prev


def table(export: dict) -> List[str]:
    """The lines of a readout: every span's calls, mean and self ms, and
    synchronisations, then every counter."""
    per = {}
    for s in export["spans"]:
        p = per.setdefault(s["name"], [0, 0, 0, 0])
        p[0] += 1
        p[1] += s["end_ns"] - s["start_ns"]
        p[2] += s["self_ns"]
        p[3] += s["syncs"]
    lines = [f"{'span':34s} {'calls':>6s} {'mean_ms':>10s} {'self_ms':>10s} {'syncs':>6s}"]
    for name, (n, tot, own, ns) in sorted(per.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"{name:34s} {n:6d} {tot / n / 1e6:10.3f} {own / n / 1e6:10.3f} {ns:6d}")
    for name, v in sorted(export["counters"].items()):
        lines.append(f"{name:34s} {v:6d}")
    lines.append(f"{'(syncs outside every span)':34s} {export['syncs_outside']:6d}")
    return lines
