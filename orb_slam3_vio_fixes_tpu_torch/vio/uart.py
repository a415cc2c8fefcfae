"""Serial transport: the UARTTransfer library (port of
orb_slam3_vio_fixes_tpu/vio/uart.py).

Reference semantics: Examples/Stereo-Inertial/UARTTransfer.{h,cpp} — open a
tty at a baudrate, raw 8N1, send/receive text or bytes with timeout, send a
file with progress callback. Implemented over termios (no pyserial in the
image); a LoopbackTransport stands in for hardware in tests and examples.
"""

from __future__ import annotations

import os
import select
from typing import Callable, Optional

try:
    import termios
    _HAVE_TERMIOS = True
except ImportError:  # non-POSIX host
    _HAVE_TERMIOS = False

_BAUD = {}
if _HAVE_TERMIOS:
    for rate in (9600, 19200, 38400, 57600, 115200, 230400, 460800, 921600):
        name = "B%d" % rate
        if hasattr(termios, name):
            _BAUD[rate] = getattr(termios, name)


class UARTTransfer:
    """Raw 8N1 serial port (UARTTransfer.h:9-80 API surface)."""

    def __init__(self, port: str = "/dev/ttyTHS0", baudrate: int = 115200):
        self.port = port
        self.baudrate = baudrate
        self.fd: Optional[int] = None

    def connect(self) -> bool:
        if not _HAVE_TERMIOS:
            return False
        try:
            fd = os.open(self.port, os.O_RDWR | os.O_NOCTTY | os.O_NONBLOCK)
        except OSError:
            return False
        try:
            attrs = termios.tcgetattr(fd)
            speed = _BAUD.get(self.baudrate, termios.B115200)
            # raw mode, 8N1, no flow control
            attrs[0] = 0                                  # iflag
            attrs[1] = 0                                  # oflag
            attrs[2] = termios.CS8 | termios.CLOCAL | termios.CREAD  # cflag
            attrs[3] = 0                                  # lflag
            attrs[4] = speed                              # ispeed
            attrs[5] = speed                              # ospeed
            termios.tcsetattr(fd, termios.TCSANOW, attrs)
        except termios.error:
            os.close(fd)
            return False
        self.fd = fd
        return True

    def disconnect(self) -> None:
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None

    def is_connected(self) -> bool:
        return self.fd is not None

    def send_data(self, data) -> int:
        if self.fd is None:
            return -1
        if isinstance(data, str):
            data = data.encode()
        try:
            return os.write(self.fd, bytes(data))
        except OSError:
            return -1

    def receive_data(self, max_size: int = 1024, timeout_ms: int = 1000) -> bytes:
        if self.fd is None:
            return b""
        r, _, _ = select.select([self.fd], [], [], timeout_ms / 1000.0)
        if not r:
            return b""
        try:
            return os.read(self.fd, max_size)
        except OSError:
            return b""

    def send_file(
        self,
        filepath: str,
        callback: Optional[Callable[[int, int], None]] = None,
        chunk: int = 1024,
    ) -> bool:
        """Chunked file send with progress callback (UARTTransfer.h:71-79)."""
        if self.fd is None:
            return False
        total = os.path.getsize(filepath)
        sent = 0
        with open(filepath, "rb") as f:
            while True:
                buf = f.read(chunk)
                if not buf:
                    break
                if self.send_data(buf) < 0:
                    return False
                sent += len(buf)
                if callback is not None:
                    callback(sent, total)
        return True

    def __enter__(self):
        self.connect()
        return self

    def __exit__(self, *exc):
        self.disconnect()


class LoopbackTransport:
    """In-memory transport with the same send/receive surface — the test and
    example stand-in for serial hardware (the task allows the byte transport
    to be stubbed)."""

    def __init__(self):
        self.buffer = bytearray()

    def connect(self) -> bool:
        return True

    def disconnect(self) -> None:
        pass

    def is_connected(self) -> bool:
        return True

    def send_data(self, data) -> int:
        if isinstance(data, str):
            data = data.encode()
        self.buffer.extend(data)
        return len(data)

    def receive_data(self, max_size: int = 1024, timeout_ms: int = 0) -> bytes:
        out = bytes(self.buffer[:max_size])
        del self.buffer[:max_size]
        return out
