"""Minimal MAVLink v2 wire encoder for the VIO fork layer's message set (port
of orb_slam3_vio_fixes_tpu/vio/mavlink.py: the same bytes).

Implements exactly the messages the reference VIO apps emit
(stereo_inertial_realsense_D455_VIO.cc:345-521 — HEARTBEAT,
REQUEST_DATA_STREAM, ODOMETRY, VISION_POSITION_ESTIMATE,
VISION_SPEED_ESTIMATE; ..._GPS_v2.cc:157-260 — GPS_INPUT), built from the
public MAVLink v2 framing spec rather than the generated C headers: magic
0xFD | len | incompat | compat | seq | sysid | compid | msgid(3B LE) |
payload (fields in wire order = sorted by type size, extensions appended;
trailing zero bytes truncated) | CRC-X25 over len..payload + per-message
CRC_EXTRA seed byte.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple

import numpy as np

MAGIC_V2 = 0xFD

MSG_HEARTBEAT = 0
MSG_REQUEST_DATA_STREAM = 66
MSG_VISION_POSITION_ESTIMATE = 102
MSG_VISION_SPEED_ESTIMATE = 103
MSG_GPS_INPUT = 232
MSG_ODOMETRY = 331

# Per-message CRC seed bytes from the public MAVLink common dialect.
CRC_EXTRA = {
    MSG_HEARTBEAT: 50,
    MSG_REQUEST_DATA_STREAM: 148,
    MSG_VISION_POSITION_ESTIMATE: 158,
    MSG_VISION_SPEED_ESTIMATE: 208,
    MSG_GPS_INPUT: 151,
    MSG_ODOMETRY: 91,
}

MAV_FRAME_LOCAL_NED = 1
MAV_FRAME_BODY_FRD = 12
MAV_TYPE_ONBOARD_CONTROLLER = 18
MAV_AUTOPILOT_INVALID = 8
MAV_STATE_ACTIVE = 4
MAV_ESTIMATOR_TYPE_VIO = 2


def crc_x25(data: bytes, crc: int = 0xFFFF) -> int:
    """X.25 / CRC-16-CCITT (the MAVLink checksum)."""
    for b in data:
        tmp = (b ^ crc) & 0xFF
        tmp = (tmp ^ (tmp << 4)) & 0xFF
        crc = ((crc >> 8) ^ (tmp << 8) ^ (tmp << 3) ^ (tmp >> 4)) & 0xFFFF
    return crc


@dataclasses.dataclass
class OdometryData:
    """Mirror of the reference's queued OdometryData struct
    (stereo_inertial_realsense_D455_VIO.cc:70-141)."""

    time_usec: int
    x: float
    y: float
    z: float
    q: Tuple[float, float, float, float]  # (w, x, y, z)
    vx: float = 0.0
    vy: float = 0.0
    vz: float = 0.0
    rollspeed: float = 0.0
    pitchspeed: float = 0.0
    yawspeed: float = 0.0
    pose_covariance: Optional[np.ndarray] = None      # (21,)
    velocity_covariance: Optional[np.ndarray] = None  # (21,)
    reset_counter: int = 0
    estimator_type: int = MAV_ESTIMATOR_TYPE_VIO
    quality: int = 0


class MAVLinkEncoder:
    """Stateful (sequence-numbered) packer for the fork's message set."""

    def __init__(self, system_id: int = 1, component_id: int = 197):
        self.system_id = system_id
        self.component_id = component_id
        self.seq = 0

    def _frame(self, msgid: int, payload: bytes) -> bytes:
        # v2 payload truncation: drop trailing zero bytes, keep >= 1
        n = len(payload)
        while n > 1 and payload[n - 1] == 0:
            n -= 1
        payload = payload[:n]
        header = struct.pack(
            "<BBBBBBBBBB",
            MAGIC_V2,
            len(payload),
            0,  # incompat_flags
            0,  # compat_flags
            self.seq & 0xFF,
            self.system_id,
            self.component_id,
            msgid & 0xFF,
            (msgid >> 8) & 0xFF,
            (msgid >> 16) & 0xFF,
        )
        self.seq = (self.seq + 1) & 0xFF
        crc = crc_x25(header[1:] + payload + bytes([CRC_EXTRA[msgid]]))
        return header + payload + struct.pack("<H", crc)

    def heartbeat(self) -> bytes:
        """HEARTBEAT as the VIO app's heartbeat thread sends it (:345-360)."""
        payload = struct.pack(
            "<IBBBBB",
            0,  # custom_mode
            MAV_TYPE_ONBOARD_CONTROLLER,
            MAV_AUTOPILOT_INVALID,
            0,  # base_mode
            MAV_STATE_ACTIVE,
            3,  # mavlink_version
        )
        return self._frame(MSG_HEARTBEAT, payload)

    def request_data_stream(
        self, target_system=1, target_component=1, stream_id=0, rate_hz=1, start=1
    ) -> bytes:
        payload = struct.pack(
            "<HBBBB", rate_hz, target_system, target_component, stream_id, start
        )
        return self._frame(MSG_REQUEST_DATA_STREAM, payload)

    def odometry(self, d: OdometryData) -> bytes:
        """ODOMETRY (#331): LOCAL_NED → BODY_FRD, like sendOdometry (:381-412)."""
        pc = np.zeros(21, np.float32) if d.pose_covariance is None else np.asarray(
            d.pose_covariance, np.float32
        )
        vc = (
            np.zeros(21, np.float32)
            if d.velocity_covariance is None
            else np.asarray(d.velocity_covariance, np.float32)
        )
        payload = struct.pack("<Q", d.time_usec)
        payload += struct.pack("<3f", d.x, d.y, d.z)
        payload += struct.pack("<4f", *d.q)
        payload += struct.pack("<3f", d.vx, d.vy, d.vz)
        payload += struct.pack("<3f", d.rollspeed, d.pitchspeed, d.yawspeed)
        payload += pc.tobytes() + vc.tobytes()
        payload += struct.pack(
            "<BBBBb",
            MAV_FRAME_LOCAL_NED,
            MAV_FRAME_BODY_FRD,
            d.reset_counter & 0xFF,
            d.estimator_type & 0xFF,
            d.quality,
        )
        return self._frame(MSG_ODOMETRY, payload)

    def vision_position_estimate(self, d: OdometryData) -> bytes:
        """VISION_POSITION_ESTIMATE (#102): roll/pitch zeroed, yaw from the
        quaternion, exactly like sendVisionPositionEstimate (:417-490)."""
        import math

        qw, qx, qy, qz = d.q
        yaw = math.atan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy * qy + qz * qz))
        pc = np.zeros(21, np.float32) if d.pose_covariance is None else np.asarray(
            d.pose_covariance, np.float32
        )
        payload = struct.pack("<Q6f", d.time_usec, d.x, d.y, d.z, 0.0, 0.0, yaw)
        payload += pc.tobytes()
        payload += struct.pack("<B", d.reset_counter & 0xFF)
        return self._frame(MSG_VISION_POSITION_ESTIMATE, payload)

    def vision_speed_estimate(self, d: OdometryData) -> bytes:
        """VISION_SPEED_ESTIMATE (#103) — the +SPEED TX mode's companion."""
        payload = struct.pack("<Q3f", d.time_usec, d.vx, d.vy, d.vz)
        payload += np.zeros(9, np.float32).tobytes()
        payload += struct.pack("<B", d.reset_counter & 0xFF)
        return self._frame(MSG_VISION_SPEED_ESTIMATE, payload)

    def gps_input(
        self,
        time_usec: int,
        lat_deg: float,
        lon_deg: float,
        alt_m: float,
        vn: float = 0.0,
        ve: float = 0.0,
        vd: float = 0.0,
        fix_type: int = 3,
        satellites_visible: int = 10,
        hdop: float = 1.0,
        vdop: float = 1.0,
        gps_id: int = 0,
        ignore_flags: int = 0,
    ) -> bytes:
        """GPS_INPUT (#232) injection like MAVLinkGPSInterface (GPS_v2.cc)."""
        payload = struct.pack("<Q", time_usec)
        payload += struct.pack("<I", 0)  # time_week_ms
        payload += struct.pack("<ii", int(lat_deg * 1e7), int(lon_deg * 1e7))
        payload += struct.pack(
            "<9f", alt_m, hdop, vdop, vn, ve, vd, 0.5, 1.0, 1.0
        )  # alt hdop vdop vn ve vd speed_acc horiz_acc vert_acc
        payload += struct.pack("<HH", ignore_flags, 0)  # ignore_flags, time_week
        payload += struct.pack("<BBB", gps_id, fix_type, satellites_visible)
        payload += struct.pack("<H", 0)  # yaw (extension)
        return self._frame(MSG_GPS_INPUT, payload)


def parse_frames(data: bytes) -> List[dict]:
    """Decode concatenated v2 frames → [{msgid, sysid, compid, seq, payload,
    crc_ok}] — the test-side verifier for the encoder."""
    out = []
    i = 0
    while i + 12 <= len(data):
        if data[i] != MAGIC_V2:
            i += 1
            continue
        plen = data[i + 1]
        end = i + 10 + plen + 2
        if end > len(data):
            break
        msgid = data[i + 7] | (data[i + 8] << 8) | (data[i + 9] << 16)
        payload = data[i + 10 : i + 10 + plen]
        crc_rx = struct.unpack("<H", data[end - 2 : end])[0]
        crc_ok = None
        if msgid in CRC_EXTRA:
            crc_ok = (
                crc_x25(data[i + 1 : i + 10 + plen] + bytes([CRC_EXTRA[msgid]]))
                == crc_rx
            )
        out.append(
            {
                "msgid": msgid,
                "sysid": data[i + 5],
                "compid": data[i + 6],
                "seq": data[i + 4],
                "payload": payload,
                "crc_ok": crc_ok,
            }
        )
        i = end
    return out
