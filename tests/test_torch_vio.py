"""The port's VIO fork layer (orb_slam3_vio_fixes_tpu_torch/vio) against the
JAX package's: the twins of tests/test_vio.py.

Tolerances:
- camera_to_ned / ned_to_gps within 1e-12 of the reference on seeded poses
  (the same float64 numpy code);
- every MAVLink frame byte-equal to the reference encoder's for the same
  OdometryData, in all four TxModes and for the heartbeat;
- parse_frames: the same decoded fields and CRC verdicts; the queue bound and
  drop-oldest exact.
"""

import math
import struct
import time

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from orb_slam3_vio_fixes_tpu import vio as jvio
from orb_slam3_vio_fixes_tpu_torch import vio as tvio
from orb_slam3_vio_fixes_tpu_torch.vio import mavlink as mv

pytest_plugins = ["torch_jax_release"]
# every thread a test starts (shards, decoder, interface loops) ends with it
pytestmark = pytest.mark.usefixtures("threads_end")

torch.set_num_threads(2)


def poses(n=16, seed=0):
    rng = np.random.default_rng(seed)
    R = Rotation.random(n, random_state=seed).as_matrix()
    return R, rng.normal(0, 5, (n, 3)), rng.normal(0, 2, (n, 3))


def test_frames_match_reference():
    R, t, v = poses()
    origin = (47.3977419, 8.5455938, 488.0)
    for k in range(len(R)):
        got = tvio.camera_to_ned(R[k], t[k], v[k])
        ref = jvio.camera_to_ned(R[k], t[k], v[k])
        for f in ("pos", "vel", "rpy", "quat"):
            assert got[f].dtype == np.float64
            np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=1e-12, err_msg=f)
        g = tvio.ned_to_gps(*got["pos"], tvio.GPSCoord(*origin))
        r = jvio.ned_to_gps(*ref["pos"], jvio.GPSCoord(*origin))
        np.testing.assert_allclose([g.lat, g.lon, g.alt], [r.lat, r.lon, r.alt],
                                   rtol=0, atol=1e-12)
    # the reference's axis conventions: forward -> north, right -> west,
    # down -> down, yaw shifted by +pi/2
    out = tvio.camera_to_ned(np.eye(3), np.array([1.0, 2.0, 3.0]))
    np.testing.assert_allclose(out["pos"], [3.0, -1.0, 2.0], atol=1e-12)
    assert abs(out["rpy"][2] - math.pi / 2) < 1e-9


@pytest.mark.parametrize("mode", ["odometry", "vision_position",
                                  "vision_position_speed", "gps_input"])
def test_interface_bytes_match_reference(mode):
    """The same poses through both MAVLinkInterfaces (with a reset between
    them) give the same bytes on the loopback, heartbeat first."""
    R, t, v = poses(6, seed=1)
    out = []
    for pkg in (tvio, jvio):
        tp = pkg.LoopbackTransport()
        itf = pkg.MAVLinkInterface(tp, mode=pkg.TxMode(mode), system_id=3,
                                   gps_origin=pkg.GPSCoord(47.0, 8.0, 100.0))
        tp.send_data(itf.encoder.heartbeat())
        for k in range(len(R)):
            itf.publish_pose(0.05 * k + 1.0, R[k], t[k], v[k])
            if k == 2:
                itf.notify_reset()
        itf.drain()
        out.append(bytes(tp.buffer))
    assert out[0] == out[1]
    frames = tvio.parse_frames(out[0])
    per_pose = 2 if mode == "vision_position_speed" else 1
    assert len(frames) == 1 + per_pose * len(R)
    assert frames[0]["msgid"] == mv.MSG_HEARTBEAT
    assert all(f["crc_ok"] is True and f["sysid"] == 3 for f in frames)
    assert [f["seq"] for f in frames] == list(range(len(frames)))


def test_encoder_and_parser_match_reference():
    """Each encoder alone, byte for byte, and parse_frames' round trip of
    the payload fields (ODOMETRY position and quaternion, VISION_POSITION
    yaw, GPS_INPUT coordinates), with a corrupted frame failing its CRC."""
    yaw = 0.7
    d = dict(time_usec=123456, x=1.5, y=-2.0, z=0.25,
             q=(math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)), vx=0.1, vy=0.2, vz=0.3,
             pose_covariance=np.arange(21, dtype=np.float32), reset_counter=7)
    enc_t, enc_j = mv.MAVLinkEncoder(9, 42), jvio.MAVLinkEncoder(9, 42)
    calls = [("heartbeat", ()), ("odometry", "d"), ("vision_position_estimate", "d"),
             ("vision_speed_estimate", "d"), ("gps_input", (99, 47.5, 8.25, 432.1)),
             ("request_data_stream", ())]
    buf = b""
    for name, args in calls:
        a_t = (tvio.OdometryData(**d),) if args == "d" else args
        a_j = (jvio.OdometryData(**d),) if args == "d" else args
        got = getattr(enc_t, name)(*a_t)
        assert got == getattr(enc_j, name)(*a_j), name
        buf += got
    frames = tvio.parse_frames(buf)
    assert frames == jvio.parse_frames(buf)
    assert [f["msgid"] for f in frames] == [0, 331, 102, 103, 232, 66]
    assert all(f["crc_ok"] for f in frames)
    p = frames[1]["payload"]
    assert struct.unpack("<Q", p[:8])[0] == 123456
    assert struct.unpack("<3f", p[8:20]) == pytest.approx((1.5, -2.0, 0.25))
    assert struct.unpack("<4f", p[20:36]) == pytest.approx(d["q"])
    vals = struct.unpack("<Q6f", frames[2]["payload"][:32].ljust(32, b"\0"))
    assert vals[6] == pytest.approx(yaw, abs=1e-6)
    lat, lon = struct.unpack("<ii", frames[4]["payload"][12:20])
    assert (lat, lon) == (int(47.5e7), 82500000)
    bad = bytearray(buf)
    bad[12] ^= 0xFF         # a payload byte of the heartbeat
    assert tvio.parse_frames(bytes(bad))[0]["crc_ok"] is False


def test_interface_queue_bounded_drops_oldest():
    tp = tvio.LoopbackTransport()
    itf = tvio.MAVLinkInterface(tp, mode=tvio.TxMode.ODOMETRY, max_queue=5)
    for i in range(12):
        itf.publish_pose(float(i), np.eye(3), np.array([0.0, 0.0, float(i)]))
    assert itf.queue.qsize() == 5
    itf.drain()
    assert itf.n_sent == 5
    frames = tvio.parse_frames(bytes(tp.buffer))
    # the five newest poses survive: 1 m forward each, north in NED
    north = [struct.unpack("<f", f["payload"][8:12])[0] for f in frames]
    assert north == [7.0, 8.0, 9.0, 10.0, 11.0]


def test_interface_threads_and_uart_fallback():
    """start() runs the heartbeat and sender threads over the transport;
    stop() joins them. A serial port that cannot be opened reports False."""
    tp = tvio.LoopbackTransport()
    itf = tvio.MAVLinkInterface(tp, heartbeat_hz=50.0)
    itf.start()
    try:
        itf.publish_pose(1.0, np.eye(3), np.zeros(3))
        for _ in range(200):
            ids = [f["msgid"] for f in tvio.parse_frames(bytes(tp.buffer))]
            if mv.MSG_ODOMETRY in ids and mv.MSG_HEARTBEAT in ids:
                break
            time.sleep(0.01)
    finally:
        itf.stop()
    assert mv.MSG_ODOMETRY in ids and mv.MSG_HEARTBEAT in ids
    assert not itf._threads
    uart = tvio.UARTTransfer("/nonexistent/tty", 115200)
    assert uart.connect() is False and uart.send_data(b"x") == -1

