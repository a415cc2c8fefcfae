"""Drone-VIO app: stereo-inertial SLAM with MAVLink pose streaming.

Fork-layer analogue of stereo_inertial_realsense_D455_VIO.cc (and its _GPS
variants): runs the stereo-inertial pipeline over a recorded sequence and
streams the estimated pose to a flight controller as MAVLink ODOMETRY /
VISION_POSITION_ESTIMATE (/ GPS_INPUT) over serial — configured by a JSON
file like the fork's nlohmann/json config, e.g.

    {"port": "/dev/ttyTHS0", "baudrate": 115200, "mode": "odometry",
     "gps_origin": {"lat": 47.39, "lon": 8.54, "alt": 488.0}}

Without a reachable serial port the transport falls back to an in-memory
loopback (live RealSense capture is out of scope here; the SLAM +
telemetry path is identical).
"""
import sys

from orb_slam3_vio_fixes_tpu_torch.apps import main_template

if __name__ == "__main__":
    sys.exit(main_template("euroc", "IMU_STEREO", __doc__))
