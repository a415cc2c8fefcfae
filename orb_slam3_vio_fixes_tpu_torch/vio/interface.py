"""MAVLinkInterface: pose→flight-controller streaming with TX modes (port of
orb_slam3_vio_fixes_tpu/vio/interface.py).

Reference semantics: the embedded MAVLinkInterface class of
stereo_inertial_realsense_D455_VIO.cc — a bounded thread-safe odometry queue
(:70-141), a 1 Hz heartbeat thread, and three TX modes selected by the JSON
config: ODOMETRY, VISION_POSITION, VISION_POSITION+SPEED (:763-810 publishes
the current SLAM pose each frame after camera→NED conversion). The GPS
variant (GPS_v2.cc:73-155) converts NED to GPS around a configured origin
and injects GPS_INPUT.

Re-design: the queue + sender is a plain worker thread over any transport
object with `send_data` (real UART or loopback); conversion math lives in
vio.frames; packing in vio.mavlink. No busy debug prints.
"""

from __future__ import annotations

import enum
import queue
import threading
import time
from typing import Optional

import numpy as np

from orb_slam3_vio_fixes_tpu_torch.vio import frames as vf
from orb_slam3_vio_fixes_tpu_torch.vio import mavlink as mv


class TxMode(enum.Enum):
    ODOMETRY = "odometry"
    VISION_POSITION = "vision_position"
    VISION_POSITION_SPEED = "vision_position_speed"
    GPS_INPUT = "gps_input"


class MAVLinkInterface:
    def __init__(
        self,
        transport,
        mode: TxMode = TxMode.ODOMETRY,
        system_id: int = 1,
        component_id: int = 197,
        gps_origin: Optional[vf.GPSCoord] = None,
        heartbeat_hz: float = 1.0,
        max_queue: int = 100,
    ):
        self.transport = transport
        self.mode = mode
        self.encoder = mv.MAVLinkEncoder(system_id, component_id)
        self.gps_origin = gps_origin or vf.GPSCoord(47.3977419, 8.5455938, 488.0)
        self.heartbeat_hz = heartbeat_hz
        self.queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self.reset_counter = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = []
        self.n_sent = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._stop.clear()
        for target in (self._heartbeat_loop, self._sender_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()

    # -- producer side -----------------------------------------------------
    def publish_pose(
        self,
        ts: float,
        R_wc: np.ndarray,
        t_wc: np.ndarray,
        v_w: Optional[np.ndarray] = None,
    ) -> None:
        """Queue the current SLAM pose; drops the oldest when full (the
        reference queue pops the front at max_size, :86-92)."""
        ned = vf.camera_to_ned(R_wc, t_wc, v_w)
        data = mv.OdometryData(
            time_usec=int(ts * 1e6),
            x=float(ned["pos"][0]),
            y=float(ned["pos"][1]),
            z=float(ned["pos"][2]),
            q=tuple(float(q) for q in ned["quat"]),
            vx=float(ned["vel"][0]),
            vy=float(ned["vel"][1]),
            vz=float(ned["vel"][2]),
            reset_counter=self.reset_counter,
        )
        try:
            self.queue.put_nowait(data)
        except queue.Full:
            try:
                self.queue.get_nowait()
            except queue.Empty:
                pass
            self.queue.put_nowait(data)

    def notify_reset(self) -> None:
        """Increment reset_counter on SLAM map reset/loss (the EKF uses it to
        discard discontinuous streams)."""
        self.reset_counter = (self.reset_counter + 1) & 0xFF

    # -- worker side -------------------------------------------------------
    def _send(self, buf: bytes) -> None:
        with self._lock:
            self.transport.send_data(buf)
            self.n_sent += 1

    def _heartbeat_loop(self) -> None:
        period = 1.0 / self.heartbeat_hz
        while not self._stop.is_set():
            self._send(self.encoder.heartbeat())
            self._stop.wait(period)

    def _sender_loop(self) -> None:
        while not self._stop.is_set():
            try:
                data = self.queue.get(timeout=0.1)
            except queue.Empty:
                continue
            self._dispatch(data)

    def drain(self) -> None:
        """Synchronously flush the queue (tests / offline replay)."""
        while True:
            try:
                data = self.queue.get_nowait()
            except queue.Empty:
                return
            self._dispatch(data)

    def _dispatch(self, data: mv.OdometryData) -> None:
        if self.mode == TxMode.ODOMETRY:
            self._send(self.encoder.odometry(data))
        elif self.mode == TxMode.VISION_POSITION:
            self._send(self.encoder.vision_position_estimate(data))
        elif self.mode == TxMode.VISION_POSITION_SPEED:
            self._send(self.encoder.vision_position_estimate(data))
            self._send(self.encoder.vision_speed_estimate(data))
        elif self.mode == TxMode.GPS_INPUT:
            gps = vf.ned_to_gps(data.x, data.y, data.z, self.gps_origin)
            self._send(
                self.encoder.gps_input(
                    data.time_usec,
                    gps.lat,
                    gps.lon,
                    gps.alt,
                    vn=data.vx,
                    ve=data.vy,
                    vd=data.vz,
                )
            )
