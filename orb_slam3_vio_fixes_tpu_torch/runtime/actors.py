"""Host pipeline runner: prefetching dataset feed + stage timing (port of
orb_slam3_vio_fixes_tpu/runtime/actors.py).

Role parity with the reference's thread runtime (System spawns
LocalMapping/LoopClosing/Viewer threads, src/System.cc:194-237) and its
REGISTER_TIMES instrumentation (per-stage std::chrono timers, mean±std dumped
to ExecMean.txt at shutdown — include/Settings.h:24, src/Tracking.cc:263-352).

Re-design: mapping and loop closing are synchronous functional updates inside
the tracker (no shared-memory races to manage), so the host concurrency that
still pays is I/O: a decoder thread prefetches and decodes frame t+1 through
a bounded native queue while the device tracks frame t. The decoder thread
handles numpy arrays only; every host-to-device copy happens in the tracking
thread, inside the facade. Stage timings are a first-class StageTimes struct
(runtime/tracing.py) with the reference's stage taxonomy; the decoder and
the tracking thread append to it without a lock (a list append is atomic
under the GIL).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np

from orb_slam3_vio_fixes_tpu_torch.runtime import native as rt_native
from orb_slam3_vio_fixes_tpu_torch.runtime.tracing import StageTimes
from orb_slam3_vio_fixes_tpu_torch.sensors import Sensor


@dataclasses.dataclass
class RunResult:
    n_frames: int
    fps: float
    times: StageTimes
    trajectory: list


class PipelineRunner:
    """Drive a SLAMSystem over a SequenceIndex with decode prefetch.

    The decoder thread stays `prefetch` frames ahead through a bounded
    hand-off (backpressure instead of unbounded RAM), mirroring how the
    reference's main loops read images ahead of TrackStereo.
    """

    def __init__(self, system, seq, prefetch: int = 4,
                 mavlink: Optional[object] = None, max_frames: Optional[int] = None):
        self.system = system
        self.seq = seq
        self.prefetch = prefetch
        self.mavlink = mavlink
        self.n = min(len(seq), max_frames) if max_frames else len(seq)
        self.times = StageTimes()
        self.used_native_queue = False

    # -- native bounded hand-off (the reference's C++ queue runtime role:
    # src/LocalMapping.cc:284-296 — here between the decode producer and
    # the tracking consumer; falls back to a Python list when the .so
    # cannot be built) --

    class _FrameCodec:
        """Fixed-layout (ts + arrays) <-> bytes for the native queue."""

        def __init__(self, template):
            ts, im_l, im_r, dep = template
            self.parts = []
            for a in (im_l, im_r, dep):
                self.parts.append(None if a is None
                                  else (np.asarray(a).shape,
                                        np.asarray(a).dtype))
            self.item_size = 8 + sum(
                int(np.prod(p[0])) * np.dtype(p[1]).itemsize
                for p in self.parts if p is not None)

        def pack(self, frame) -> bytes:
            ts, im_l, im_r, dep = frame
            out = [np.float64(ts).tobytes()]
            for a in (im_l, im_r, dep):
                if a is not None:
                    out.append(np.ascontiguousarray(a).tobytes())
            return b"".join(out)

        def unpack(self, buf: bytes):
            ts = float(np.frombuffer(buf[:8], np.float64)[0])
            off = 8
            arrs = []
            for p in self.parts:
                if p is None:
                    arrs.append(None)
                    continue
                shape, dtype = p
                nb = int(np.prod(shape)) * np.dtype(dtype).itemsize
                arrs.append(np.frombuffer(
                    buf[off:off + nb], dtype).reshape(shape).copy())
                off += nb
            return (ts,) + tuple(arrs)

    def _decoder(self, out_q, stop, codec, slots):
        for i in range(self.n):
            if stop.is_set():
                return
            t0 = time.perf_counter()
            frame = self.seq.frame(i)
            self.times.add("decode", time.perf_counter() - t0)
            # block for a free slot (the consumer frees one per frame it
            # takes) rather than poll: a thread that wakes every millisecond
            # takes the GIL from the launch-bound tracking thread (1 ms
            # polling cost 25-35% of the median frame on an H100, PERF.md)
            while not slots.acquire(timeout=0.1):
                if stop.is_set():
                    return
            if isinstance(out_q, rt_native.NativeQueue):
                if not out_q.push(codec.pack(frame)):
                    raise RuntimeError("the frame queue is full with a slot free")
            else:
                out_q.append(frame)

    def run(self) -> RunResult:
        sysm = self.system
        sensor = sysm.sensor
        codec = self._FrameCodec(self.seq.frame(0))
        if rt_native.native_available():
            out_q = rt_native.NativeQueue(self.prefetch, codec.item_size)
            self.used_native_queue = True
        else:
            out_q = []
        stop = threading.Event()
        slots = threading.Semaphore(self.prefetch)
        dec = threading.Thread(target=self._decoder, args=(out_q, stop, codec, slots),
                               name="frame-decoder", daemon=True)
        dec.start()

        prev_ts = None
        t_start = time.perf_counter()
        try:
            for i in range(self.n):
                if self.used_native_queue:
                    buf = None
                    while buf is None:
                        buf = out_q.pop(timeout_ms=100)
                        if (buf is None and not dec.is_alive()
                                and out_q.size() == 0):
                            raise RuntimeError(
                                "frame decoder ended before the sequence")
                    ts, im_l, im_r, dep = codec.unpack(buf)
                else:
                    while not out_q:
                        if not dec.is_alive() and not out_q:
                            raise RuntimeError(
                                "frame decoder ended before the sequence")
                        time.sleep(0.001)
                    ts, im_l, im_r, dep = out_q.pop(0)
                slots.release()

                imu = None
                if sensor.has_imu and self.seq.imu is not None and prev_ts is not None:
                    chunk = self.seq.imu_between(prev_ts, ts)
                    # tracker wants (n, 7) rows of [acc(3), gyro(3), dt]
                    dts = np.diff(chunk.ts, prepend=prev_ts)
                    imu = np.concatenate(
                        [chunk.acc, chunk.gyro, dts[:, None]], axis=1
                    ).astype(np.float32)
                prev_ts = ts

                with self.times.scope("track"):
                    if sensor in (Sensor.STEREO, Sensor.IMU_STEREO):
                        sysm.track_stereo(im_l, im_r, ts, imu=imu)
                    elif sensor.is_rgbd:
                        sysm.track_rgbd(im_l, dep, ts, imu=imu)
                    else:
                        sysm.track_monocular(im_l, ts, imu=imu)

                if self.mavlink is not None and sysm.tracker.traj:
                    # live pose from the tracker (reconstructing the whole
                    # relative-pose trajectory every frame would be O(n)); one
                    # device pull, where the tracker has synchronised already
                    R_cw = sysm.tracker.R.cpu().numpy()
                    t_cw = sysm.tracker.t.cpu().numpy()
                    R_wc = R_cw.T
                    t_wc = -R_wc @ t_cw
                    self.mavlink.publish_pose(ts, R_wc, t_wc)
        finally:
            stop.set()
            dec.join(timeout=2.0)
            if self.used_native_queue:
                out_q.close()

        wall = time.perf_counter() - t_start
        return RunResult(
            n_frames=self.n,
            fps=self.n / wall if wall > 0 else 0.0,
            times=self.times,
            trajectory=sysm.tracker.trajectory,
        )
