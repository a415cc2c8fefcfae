"""Fork-layer drone-VIO output: MAVLink odometry/GPS streaming + UART (port
of orb_slam3_vio_fixes_tpu/vio/, numpy and the standard library only).

The framework's equivalent of the VIO_FIXES fork layer (reference:
Examples/Stereo-Inertial/stereo_inertial_realsense_D455_VIO.cc — embedded
MAVLinkInterface with heartbeat thread + thread-safe odometry queue +
camera→NED conversion + three TX modes; ..._GPS_v2.cc — NED→GPS conversion
and GPS_INPUT injection; UARTTransfer.{h,cpp} — serial I/O library).
"""

from orb_slam3_vio_fixes_tpu_torch.vio.frames import (
    camera_to_ned,
    ned_to_gps,
    GPSCoord,
)
from orb_slam3_vio_fixes_tpu_torch.vio.mavlink import (
    MAVLinkEncoder,
    OdometryData,
    parse_frames,
)
from orb_slam3_vio_fixes_tpu_torch.vio.uart import UARTTransfer, LoopbackTransport
from orb_slam3_vio_fixes_tpu_torch.vio.interface import MAVLinkInterface, TxMode

__all__ = [
    "camera_to_ned",
    "ned_to_gps",
    "GPSCoord",
    "MAVLinkEncoder",
    "OdometryData",
    "parse_frames",
    "UARTTransfer",
    "LoopbackTransport",
    "MAVLinkInterface",
    "TxMode",
]
