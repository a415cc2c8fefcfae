"""Build and load the port's hand-written CUDA kernels.

The sources in `csrc/` have a plain C interface. At first use they are
compiled by `nvcc` for `sm_90a` into one shared library under `build/kernels/`
at the repository root (git-ignored) and loaded with `ctypes`. The library's
file name carries a hash of the sources and flags, so an edited source is
rebuilt and a stale build is never loaded.

Nothing here runs at import: the CPU tests import every module on a machine
without `nvcc` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from orb_slam3_vio_fixes_tpu_torch.runtime import tracing

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("fast_score.cu", "hamming.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # in, out, B, H, W, stream
    "slam_fast_score": (_P, _P, _I, _I, _I, _P),
    # desc_q, desc_t, mask, Q, T, want_cols, best_idx, best, second,
    # second_idx, col_key, stream
    "slam_hamming_match": (_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libslam_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the sources if their library is missing. Returns (path,
    seconds spent compiling)."""
    so = library_path()
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so, dt


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    with tracing.span("kernels.build"):
        so, _ = build()
        lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")


# Launches per kernel, counted by each wrapper where it launches its kernel
# ("hamming_match_cols" counts the K2 launches that also reduce columns).
# The shards of a parallel.Mesh launch from threads of their own: `count`
# takes a lock, as `+=` from several threads can lose counts.
LAUNCHES = {"fast_score": 0, "hamming_match": 0, "hamming_match_cols": 0}
_LAUNCH_LOCK = threading.Lock()


def count(name: str, n: int = 1) -> None:
    with _LAUNCH_LOCK:
        LAUNCHES[name] += n


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> dict:
    with _LAUNCH_LOCK:
        return dict(LAUNCHES)
