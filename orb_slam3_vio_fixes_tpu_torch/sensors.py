"""Sensor-configuration enum (port of orb_slam3_vio_fixes_tpu/sensors.py)."""

from __future__ import annotations

import enum


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2
    IMU_MONOCULAR = 3
    IMU_STEREO = 4
    IMU_RGBD = 5

    @property
    def has_imu(self) -> bool:
        return self in (Sensor.IMU_MONOCULAR, Sensor.IMU_STEREO, Sensor.IMU_RGBD)

    @property
    def is_stereo(self) -> bool:
        return self in (Sensor.STEREO, Sensor.IMU_STEREO)

    @property
    def is_rgbd(self) -> bool:
        return self in (Sensor.RGBD, Sensor.IMU_RGBD)

    @property
    def is_monocular(self) -> bool:
        return self in (Sensor.MONOCULAR, Sensor.IMU_MONOCULAR)
