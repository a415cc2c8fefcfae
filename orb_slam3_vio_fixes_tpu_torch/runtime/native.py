"""ctypes bindings to the native C++ host runtime (port of
orb_slam3_vio_fixes_tpu/runtime/native.py).

The library, compiled from `native/orbslam3_tpu_rt.cpp` at the repository
root, provides the bounded queues between host actors and host-side Hamming
matching (role parity with the reference's C++ thread/queue runtime,
src/LocalMapping.cc:284-296 / src/LoopClosing.cc:311-322, and
ORBmatcher::DescriptorDistance include/ORBmatcher.h:43). It is built at first
use with g++ and the flags of `native/build.sh` into `build/native/`
(git-ignored), under a name that carries a hash of the source and flags, so
an edited source is rebuilt and a stale build is never loaded. On a host
with no compiler the queue and the matchers fall back to Python and numpy:
this is host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import queue as _pyqueue
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "orbslam3_tpu_rt.cpp"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"liborbslam3_tpu_rt_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the runtime if its library is missing; returns its path.
    Raises when g++ is absent or fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # concurrent builders (test workers) each write their own file and
    # rename it into place
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def _try_load() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    lib.rt_queue_create.restype = ctypes.c_void_p
    lib.rt_queue_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int]
    lib.rt_queue_destroy.argtypes = [ctypes.c_void_p]
    lib.rt_queue_push.restype = ctypes.c_int
    lib.rt_queue_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rt_queue_pop.restype = ctypes.c_int
    lib.rt_queue_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.rt_queue_size.restype = ctypes.c_size_t
    lib.rt_queue_size.argtypes = [ctypes.c_void_p]
    lib.rt_queue_close.argtypes = [ctypes.c_void_p]
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.rt_hamming_match.argtypes = [
        u8p, ctypes.c_size_t, u8p, ctypes.c_size_t, i32p, i32p, i32p,
    ]
    lib.rt_hamming_matrix.argtypes = [u8p, ctypes.c_size_t, u8p, ctypes.c_size_t, i32p]
    return lib


def native_available() -> bool:
    return _try_load() is not None


class NativeQueue:
    """Bounded fixed-item-size byte queue; native when possible.

    drop_oldest=True mirrors the fork's odometry queue; False mirrors the
    reference's reject-when-full keyframe queue.
    """

    def __init__(self, capacity: int, item_size: int, drop_oldest: bool = False):
        self.capacity = capacity
        self.item_size = item_size
        self.drop_oldest = drop_oldest
        lib = _try_load()
        self._lib = lib
        if lib is not None:
            self._q = lib.rt_queue_create(capacity, item_size, int(drop_oldest))
        else:
            self._q = None
            self._pyq: "_pyqueue.Queue" = _pyqueue.Queue(maxsize=capacity)

    def push(self, data: bytes) -> bool:
        if len(data) != self.item_size:
            raise ValueError(f"item of {len(data)} bytes in a queue of "
                             f"{self.item_size}-byte items")
        if self._q is not None:
            return bool(self._lib.rt_queue_push(self._q, data))
        try:
            self._pyq.put_nowait(data)
            return True
        except _pyqueue.Full:
            if not self.drop_oldest:
                return False
            try:
                self._pyq.get_nowait()
            except _pyqueue.Empty:
                pass
            self._pyq.put_nowait(data)
            return True

    def pop(self, timeout_ms: int = 100) -> Optional[bytes]:
        if self._q is not None:
            buf = ctypes.create_string_buffer(self.item_size)
            ok = self._lib.rt_queue_pop(self._q, buf, timeout_ms)
            return buf.raw if ok else None
        try:
            return self._pyq.get(timeout=timeout_ms / 1000.0)
        except _pyqueue.Empty:
            return None

    def size(self) -> int:
        if self._q is not None:
            return int(self._lib.rt_queue_size(self._q))
        return self._pyq.qsize()

    def close(self) -> None:
        if self._q is not None:
            self._lib.rt_queue_close(self._q)

    def __del__(self):
        if getattr(self, "_q", None) is not None and self._lib is not None:
            self._lib.rt_queue_destroy(self._q)
            self._q = None


def hamming_match(
    queries: np.ndarray, db: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Best/second-best Hamming match: (best_idx, best_dist, second_dist)."""
    q = np.ascontiguousarray(queries, dtype=np.uint8)
    d = np.ascontiguousarray(db, dtype=np.uint8)
    nq, nd = q.shape[0], d.shape[0]
    lib = _try_load()
    if lib is None or not nq or not nd:
        return hamming_match_plain(q, d)
    bi = np.empty(nq, np.int32)
    b1 = np.empty(nq, np.int32)
    b2 = np.empty(nq, np.int32)
    lib.rt_hamming_match(q, nq, d, nd, bi, b1, b2)
    return bi, b1, b2


def hamming_matrix(queries: np.ndarray, db: np.ndarray) -> np.ndarray:
    """(nq, nd) pairwise Hamming distances over 32-byte descriptors."""
    q = np.ascontiguousarray(queries, dtype=np.uint8)
    d = np.ascontiguousarray(db, dtype=np.uint8)
    nq, nd = q.shape[0], d.shape[0]
    lib = _try_load()
    if lib is None or not nq or not nd:
        return hamming_matrix_plain(q, d)
    out = np.empty((nq, nd), np.int32)
    lib.rt_hamming_matrix(q, nq, d, nd, out)
    return out


# -- the numpy twins: the fallback, and what the library is checked against --

def hamming_match_plain(
    queries: np.ndarray, db: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    q = np.ascontiguousarray(queries, dtype=np.uint8)
    d = np.ascontiguousarray(db, dtype=np.uint8)
    nq, nd = q.shape[0], d.shape[0]
    if nd == 0 or nq == 0:
        return (
            np.full(nq, -1, np.int32),
            np.full(nq, 257, np.int32),
            np.full(nq, 257, np.int32),
        )
    mat = hamming_matrix_plain(q, d)
    # stable: ties go to the lowest index, as in the library's scan
    order = np.argsort(mat, axis=1, kind="stable")
    bi = order[:, 0].astype(np.int32)
    b1 = mat[np.arange(nq), bi]
    b2 = (
        mat[np.arange(nq), order[:, 1]]
        if nd > 1
        else np.full(nq, 257, np.int32)
    )
    return bi, b1.astype(np.int32), b2.astype(np.int32)


def hamming_matrix_plain(queries: np.ndarray, db: np.ndarray) -> np.ndarray:
    q = np.ascontiguousarray(queries, dtype=np.uint8)
    d = np.ascontiguousarray(db, dtype=np.uint8)
    bits = np.unpackbits(q[:, None, :] ^ d[None, :, :], axis=-1)
    return bits.sum(-1).astype(np.int32)
