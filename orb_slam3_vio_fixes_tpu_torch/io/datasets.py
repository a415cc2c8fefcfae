"""Dataset loaders: EuRoC / TUM-VI (mav0), KITTI odometry, TUM-RGBD (port of
orb_slam3_vio_fixes_tpu/io/datasets.py, numpy only).

Loaders return index objects (paths and numpy timestamp arrays) and decode
lazily with `read_image` / `read_depth`, which import PIL inside the call:
the rest of the port never needs PIL. IMU streams are dense float64 arrays
(ts, gyro, acc), sliced per frame with `ImuData.between`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np


def read_image(path: str) -> np.ndarray:
    """Decode an image to float32 grayscale HxW in [0,255].

    Mirrors the reference's cv::imread + cvtColor-to-gray step
    (src/Tracking.cc:1462-1489) with ITU-R BT.601 weights.
    """
    from PIL import Image

    with Image.open(path) as im:
        if im.mode in ("I;16", "I"):
            arr = np.asarray(im, dtype=np.float32)
            return arr
        if im.mode != "L":
            im = im.convert("L")
        return np.asarray(im, dtype=np.float32)


def read_depth(path: str, depth_factor: float = 5000.0) -> np.ndarray:
    """Decode a 16-bit depth map to meters (TUM-RGBD convention: /5000)."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im, dtype=np.float32)
    return arr / depth_factor


@dataclasses.dataclass
class ImuData:
    """Dense IMU stream: timestamps [s], gyro [rad/s], acc [m/s^2]."""

    ts: np.ndarray     # (M,) float64 seconds
    gyro: np.ndarray   # (M, 3) float64
    acc: np.ndarray    # (M, 3) float64

    def between(self, t0: float, t1: float) -> "ImuData":
        """Samples with t0 < ts <= t1 (the reference drains its IMU queue up
        to the current frame stamp, src/Tracking.cc:1624-1655)."""
        i0 = int(np.searchsorted(self.ts, t0, side="right"))
        i1 = int(np.searchsorted(self.ts, t1, side="right"))
        return ImuData(self.ts[i0:i1], self.gyro[i0:i1], self.acc[i0:i1])


@dataclasses.dataclass
class SequenceIndex:
    """Lazy index over a dataset sequence."""

    ts: np.ndarray                      # (N,) float64 seconds (camera stamps)
    left: List[str]                     # image paths
    right: Optional[List[str]] = None   # stereo pair paths (or None)
    depth: Optional[List[str]] = None   # depth map paths (RGB-D; or None)
    imu: Optional[ImuData] = None
    depth_factor: float = 5000.0

    def __len__(self) -> int:
        return len(self.left)

    def frame(self, i: int):
        """Decode frame i → (ts, left, right_or_None, depth_or_None)."""
        im_l = read_image(self.left[i])
        im_r = read_image(self.right[i]) if self.right is not None else None
        dep = (
            read_depth(self.depth[i], self.depth_factor)
            if self.depth is not None
            else None
        )
        return float(self.ts[i]), im_l, im_r, dep

    def imu_between(self, t0: float, t1: float) -> Optional[ImuData]:
        return self.imu.between(t0, t1) if self.imu is not None else None


def _load_euroc_imu(csv_path: str) -> ImuData:
    """mav0/imu0/data.csv: ts[ns], wx, wy, wz, ax, ay, az."""
    rows = np.loadtxt(csv_path, delimiter=",", comments="#", dtype=np.float64)
    rows = np.atleast_2d(rows)
    return ImuData(ts=rows[:, 0] * 1e-9, gyro=rows[:, 1:4], acc=rows[:, 4:7])


def load_euroc(
    seq_dir: str,
    timestamps_file: Optional[str] = None,
    stereo: bool = True,
    with_imu: bool = True,
) -> SequenceIndex:
    """EuRoC MAV / TUM-VI layout: <seq>/mav0/{cam0,cam1}/data/<ts>.png,
    <seq>/mav0/imu0/data.csv. If `timestamps_file` is given (the reference's
    EuRoC_TimeStamps/*.txt, one ns stamp per line) it selects/orders frames;
    otherwise all cam0 images sorted by stamp are used."""
    cam0 = os.path.join(seq_dir, "mav0", "cam0", "data")
    cam1 = os.path.join(seq_dir, "mav0", "cam1", "data")
    if timestamps_file is not None:
        stamps = [
            line.strip()
            for line in open(timestamps_file)
            if line.strip() and not line.startswith("#")
        ]
        names = [s + ".png" for s in stamps]
    else:
        names = sorted(n for n in os.listdir(cam0) if n.endswith(".png"))
        stamps = [os.path.splitext(n)[0] for n in names]
    ts = np.array([int(s) for s in stamps], dtype=np.float64) * 1e-9
    left = [os.path.join(cam0, n) for n in names]
    right = [os.path.join(cam1, n) for n in names] if stereo else None
    imu = None
    if with_imu:
        imu_csv = os.path.join(seq_dir, "mav0", "imu0", "data.csv")
        if os.path.exists(imu_csv):
            imu = _load_euroc_imu(imu_csv)
    return SequenceIndex(ts=ts, left=left, right=right, imu=imu)


# TUM-VI ships the same mav0 layout as EuRoC.
load_tum_vi = load_euroc


def load_kitti(seq_dir: str, stereo: bool = True) -> SequenceIndex:
    """KITTI odometry layout: <seq>/image_0/%06d.png, image_1, times.txt."""
    times = np.loadtxt(os.path.join(seq_dir, "times.txt"), dtype=np.float64)
    times = np.atleast_1d(times)
    n = len(times)
    left = [os.path.join(seq_dir, "image_0", "%06d.png" % i) for i in range(n)]
    right = (
        [os.path.join(seq_dir, "image_1", "%06d.png" % i) for i in range(n)]
        if stereo
        else None
    )
    return SequenceIndex(ts=times, left=left, right=right)


def _read_tum_list(path: str) -> Tuple[np.ndarray, List[str]]:
    ts, names = [], []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        ts.append(float(parts[0]))
        names.append(parts[1])
    return np.array(ts, dtype=np.float64), names


def load_tum_rgbd(
    seq_dir: str,
    associations_file: Optional[str] = None,
    max_dt: float = 0.02,
    depth_factor: float = 5000.0,
) -> SequenceIndex:
    """TUM-RGBD: rgb.txt + depth.txt (+ optional pre-built associations file
    of `ts_rgb rgb_path ts_depth depth_path` lines, like the reference's
    Examples/RGB-D/associations/)."""
    if associations_file is not None:
        ts, rgb, dep = [], [], []
        for line in open(associations_file):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            ts.append(float(p[0]))
            rgb.append(os.path.join(seq_dir, p[1]))
            dep.append(os.path.join(seq_dir, p[3]))
        return SequenceIndex(
            ts=np.array(ts), left=rgb, depth=dep, depth_factor=depth_factor
        )
    ts_rgb, rgb_names = _read_tum_list(os.path.join(seq_dir, "rgb.txt"))
    ts_dep, dep_names = _read_tum_list(os.path.join(seq_dir, "depth.txt"))
    # nearest-timestamp association (reference ships associate.py for this)
    ts, rgb, dep = [], [], []
    for i, t in enumerate(ts_rgb):
        j = int(np.argmin(np.abs(ts_dep - t)))
        if abs(ts_dep[j] - t) <= max_dt:
            ts.append(t)
            rgb.append(os.path.join(seq_dir, rgb_names[i]))
            dep.append(os.path.join(seq_dir, dep_names[j]))
    return SequenceIndex(
        ts=np.array(ts), left=rgb, depth=dep, depth_factor=depth_factor
    )


def load_tum_mono(seq_dir: str) -> SequenceIndex:
    """TUM-RGBD monocular: rgb.txt only (mono_tum.cc:157)."""
    ts, names = _read_tum_list(os.path.join(seq_dir, "rgb.txt"))
    return SequenceIndex(ts=ts, left=[os.path.join(seq_dir, n) for n in names])
