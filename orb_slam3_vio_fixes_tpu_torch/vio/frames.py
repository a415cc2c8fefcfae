"""Coordinate-frame conversions for the VIO fork layer (port of
orb_slam3_vio_fixes_tpu/vio/frames.py; float64 numpy, as there).

Reference semantics:
  * camera→NED: stereo_inertial_realsense_D455_VIO.cc:761-810 — ORB-SLAM3
    camera frame (X right, Y down, Z forward) to NED (X north, Y east,
    Z down): north = z, east = -x, down = y; yaw shifted by +pi/2 and
    wrapped, pitch negated.
  * NED→GPS: stereo_inertial_realsense_D455_VIO_GPS_v2.cc:81-98 — flat-earth
    small-offset conversion around an origin with EARTH_RADIUS, alt = origin
    - down.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

EARTH_RADIUS = 6371000.0  # meters (reference GPS_v2 EARTH_RADIUS constant)

# Rows express NED axes in camera coordinates: N=+Zc, E=-Xc, D=+Yc
# (stereo_inertial_realsense_D455_VIO.cc:766-768).
R_NED_FROM_CAM = np.array(
    [[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], dtype=np.float64
)


def _wrap_pi(a: float) -> float:
    while a > math.pi:
        a -= 2 * math.pi
    while a < -math.pi:
        a += 2 * math.pi
    return a


def camera_to_ned(R_wc: np.ndarray, t_wc: np.ndarray, v_w=None):
    """Convert a camera-to-world pose (world in the first-camera frame, as the
    SLAM map defines it) to NED position / velocity / euler / quaternion.

    Returns dict with pos(3,), vel(3,), rpy(3,), quat(4,) (w,x,y,z).
    """
    t_wc = np.asarray(t_wc, dtype=np.float64).reshape(3)
    pos = R_NED_FROM_CAM @ t_wc
    vel = (
        R_NED_FROM_CAM @ np.asarray(v_w, dtype=np.float64).reshape(3)
        if v_w is not None
        else np.zeros(3)
    )

    # ZYX euler of the camera pose, then the reference's axis fixups
    # (:775-788): roll kept, pitch negated, yaw + pi/2 wrapped.
    R = np.asarray(R_wc, dtype=np.float64)
    yaw = math.atan2(R[1, 0], R[0, 0])
    pitch = math.asin(max(-1.0, min(1.0, -R[2, 0])))
    roll = math.atan2(R[2, 1], R[2, 2])
    rpy = np.array([roll, -pitch, _wrap_pi(yaw + math.pi / 2)])

    # NED attitude quaternion from the fixed-up euler angles (w,x,y,z)
    cr, sr = math.cos(rpy[0] / 2), math.sin(rpy[0] / 2)
    cp, sp = math.cos(rpy[1] / 2), math.sin(rpy[1] / 2)
    cy, sy = math.cos(rpy[2] / 2), math.sin(rpy[2] / 2)
    quat = np.array(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ]
    )
    return {"pos": pos, "vel": vel, "rpy": rpy, "quat": quat}


@dataclasses.dataclass
class GPSCoord:
    lat: float  # degrees
    lon: float  # degrees
    alt: float  # meters MSL


def ned_to_gps(north: float, east: float, down: float, origin: GPSCoord) -> GPSCoord:
    """Flat-earth NED offset → GPS around `origin` (GPS_v2.cc:81-98)."""
    lat_rad = math.radians(origin.lat)
    d_lat = north / EARTH_RADIUS
    d_lon = east / (EARTH_RADIUS * math.cos(lat_rad))
    return GPSCoord(
        lat=origin.lat + math.degrees(d_lat),
        lon=origin.lon + math.degrees(d_lon),
        alt=origin.alt - down,
    )
