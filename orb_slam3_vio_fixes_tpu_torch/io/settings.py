"""Typed settings parser for the calibration files in configs/ (v1.0 schema;
port of orb_slam3_vio_fixes_tpu/io/settings.py).

The reference reads the files with PyYAML. The port parses the OpenCV-YAML
subset those files use itself, so it needs no YAML package: `key: value`
lines with scalars (ints, floats, quoted strings, booleans), nested blocks
of indented `key: value` lines (the `rows` / `cols` / `data` matrices, their
`data` list spanning several lines), `#` comments, and the `%YAML` / `---`
header lines, which are skipped.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

from orb_slam3_vio_fixes_tpu_torch.sensors import Sensor
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera


class SettingsError(KeyError):
    pass


_INT = re.compile(r"[-+]?\d+")


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#":
            return line[:i]
    return line


def _scalar(text: str):
    t = text.strip()
    if not t or t in ("~", "null", "Null", "NULL"):
        return None
    if len(t) >= 2 and t[0] in "\"'" and t[-1] == t[0]:
        return t[1:-1]
    if t.lower() in ("true", "false"):
        return t.lower() == "true"
    if t.startswith("[") and t.endswith("]"):
        return [_scalar(x) for x in t[1:-1].split(",") if x.strip()]
    if _INT.fullmatch(t):
        return int(t)
    try:
        return float(t)
    except ValueError:
        return t


def parse_yaml(text: str) -> dict:
    """The OpenCV-YAML subset of the configs: a flat dict of top-level keys;
    a key with an indented block below it maps to a dict of that block."""
    out: dict = {}
    block = None        # the dict of the open indented block
    pending = None      # (dict, key, text) of a flow list still open
    for raw in text.splitlines():
        if raw.startswith("%YAML") or raw.startswith("---"):
            continue
        line = _strip_comment(raw).rstrip()
        if pending is not None:
            d, key, acc = pending
            acc += " " + line.strip()
            if "]" in line:
                d[key] = _scalar(acc)
                pending = None
            else:
                pending = (d, key, acc)
            continue
        if not line.strip():
            continue
        indented = line[0] in " \t"
        key, sep, value = line.strip().partition(":")
        if not sep:
            raise SettingsError(f"cannot parse settings line: {raw!r}")
        key, value = key.strip(), value.strip()
        if indented and block is not None:
            target = block
        else:
            target, block = out, None
        if not value and target is out:
            block = out[key] = {}
        elif value.startswith("[") and "]" not in value:
            pending = (target, key, value)
        else:
            target[key] = _scalar(value)
    return out


def _load_yaml(path: str) -> dict:
    with open(path) as f:
        return parse_yaml(f.read())


def camera_matrix(cam: Camera) -> np.ndarray:
    return np.array([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
                    np.float64)


@dataclasses.dataclass
class Settings:
    sensor: Sensor
    camera_type: str
    cam1: Camera
    cam2: Optional[Camera]
    width: int
    height: int
    new_width: Optional[int]
    new_height: Optional[int]
    fps: float
    rgb: bool
    bf: float
    th_depth: float
    # stereo extrinsics (camera1 -> camera2)
    T_c1_c2: Optional[np.ndarray]
    # IMU
    noise_gyro: float = 0.0
    noise_acc: float = 0.0
    walk_gyro: float = 0.0
    walk_acc: float = 0.0
    imu_freq: float = 0.0
    T_bc: Optional[np.ndarray] = None
    insert_kfs_when_lost: bool = True
    # ORB
    n_features: int = 1200
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_th: int = 20
    fast_th_min: int = 7
    # Atlas
    load_file: str = ""
    save_file: str = ""
    # distortion (radial-tangential [k1, k2, p1, p2, k3]; None = none)
    dist1: Optional[np.ndarray] = None
    dist2: Optional[np.ndarray] = None
    # precomputed rectification / undistortion
    rect: Optional[object] = None
    undist_map: Optional[np.ndarray] = None

    @property
    def needs_rectification(self) -> bool:
        """A distorted stereo pin-hole rig: both eyes are remapped per frame."""
        return (self.sensor.is_stereo and self.camera_type == "PinHole"
                and self.T_c1_c2 is not None
                and (self.dist1 is not None or self.dist2 is not None))

    @property
    def needs_undistortion(self) -> bool:
        """A distorted mono / RGB-D pin-hole camera: one remap per frame."""
        return (not self.sensor.is_stereo and self.camera_type == "PinHole"
                and self.dist1 is not None)

    def precompute_rectification(self) -> None:
        """Rectification maps; cam1 and bf are rewritten from P1, and R_r1_u1
        is folded into T_bc for inertial rigs."""
        from orb_slam3_vio_fixes_tpu_torch.ops import rectify as rec

        if self.rect is not None or not self.needs_rectification:
            return
        K1 = camera_matrix(self.cam1)
        K2 = camera_matrix(self.cam2 if self.cam2 is not None else self.cam1)
        d1 = self.dist1 if self.dist1 is not None else np.zeros(5)
        d2 = self.dist2 if self.dist2 is not None else np.zeros(5)
        w = self.new_width or self.width
        h = self.new_height or self.height
        r = rec.stereo_rectify(K1, d1, K2, d2, (w, h), self.T_c1_c2)
        self.rect = r
        self.cam1 = Camera.pinhole(r.P1[0, 0], r.P1[1, 1], r.P1[0, 2], r.P1[1, 2])
        self.cam2 = None
        self.bf = r.baseline * r.fx
        if self.T_bc is not None:
            T_r1_u1 = np.eye(4)
            T_r1_u1[:3, :3] = r.R1
            self.T_bc = self.T_bc @ np.linalg.inv(T_r1_u1)

    def precompute_undistortion(self) -> None:
        """The mono / RGB-D undistortion remap (identity rotation, same K)."""
        from orb_slam3_vio_fixes_tpu_torch.ops import rectify as rec

        if self.undist_map is not None or not self.needs_undistortion:
            return
        K = camera_matrix(self.cam1)
        w = self.new_width or self.width
        h = self.new_height or self.height
        self.undist_map = rec.init_undistort_rectify_map(K, self.dist1, np.eye(3), K, (w, h))


def _req(d: dict, key: str):
    if key not in d or d[key] is None:
        raise SettingsError(f"Missing required settings key: {key}")
    return d[key]


def _opt(d: dict, key: str, default=None):
    return d.get(key, default)


def _read_camera(d: dict, prefix: str, cam_type: str) -> Camera:
    fx, fy, cx, cy = (_req(d, f"{prefix}.{k}") for k in ("fx", "fy", "cx", "cy"))
    if cam_type == "KannalaBrandt8":
        return Camera.kb8(fx, fy, cx, cy, *(_req(d, f"{prefix}.k{i}") for i in range(1, 5)))
    return Camera.pinhole(fx, fy, cx, cy)


def _read_dist(d: dict, prefix: str) -> Optional[np.ndarray]:
    """Radial-tangential [k1, k2, p1, p2, k3]; None when all are absent."""
    vals = [float(_opt(d, f"{prefix}.{k}", 0.0) or 0.0) for k in ("k1", "k2", "p1", "p2", "k3")]
    return np.asarray(vals, np.float64) if any(v != 0.0 for v in vals) else None


def _read_mat(d: dict, key: str) -> Optional[np.ndarray]:
    v = _opt(d, key)
    if v is None:
        return None
    if isinstance(v, dict) and "data" in v:
        rows, cols = int(v.get("rows", 4)), int(v.get("cols", 4))
        return np.asarray(v["data"], np.float64).reshape(rows, cols)
    return np.asarray(v, np.float64)


def load_settings(path: str, sensor: Sensor) -> Settings:
    d = _load_yaml(path)
    version = str(_opt(d, "File.version", ""))
    if version != "1.0":
        raise SettingsError(f"Settings file version '{version}' unsupported (need 1.0)")
    cam_type = _req(d, "Camera.type")
    cam1 = _read_camera(d, "Camera1", cam_type)
    cam2 = None
    T_c1_c2 = None
    bf = 0.0
    if sensor.is_stereo or sensor.is_rgbd:
        if sensor.is_stereo and cam_type != "Rectified":
            cam2 = _read_camera(d, "Camera2", cam_type)
            T_c1_c2 = _read_mat(d, "Stereo.T_c1_c2")
        if "Camera.bf" in d:
            bf = float(d["Camera.bf"])
        elif "Stereo.b" in d:
            bf = float(d["Stereo.b"]) * float(_req(d, "Camera1.fx"))
        elif T_c1_c2 is not None:
            bf = float(np.linalg.norm(T_c1_c2[:3, 3])) * float(_req(d, "Camera1.fx"))
    s = Settings(
        sensor=sensor, camera_type=cam_type, cam1=cam1, cam2=cam2,
        width=int(_req(d, "Camera.width")), height=int(_req(d, "Camera.height")),
        new_width=_opt(d, "Camera.newWidth"), new_height=_opt(d, "Camera.newHeight"),
        fps=float(_opt(d, "Camera.fps", 30.0)), rgb=bool(_opt(d, "Camera.RGB", 1)), bf=bf,
        dist1=_read_dist(d, "Camera1") if cam_type == "PinHole" else None,
        dist2=(_read_dist(d, "Camera2")
               if cam_type == "PinHole" and cam2 is not None else None),
        th_depth=float(_opt(d, "Stereo.ThDepth", _opt(d, "RGBD.ThDepth", 35.0)) or 35.0),
        T_c1_c2=T_c1_c2)
    if sensor.has_imu:
        s.noise_gyro = float(_req(d, "IMU.NoiseGyro"))
        s.noise_acc = float(_req(d, "IMU.NoiseAcc"))
        s.walk_gyro = float(_req(d, "IMU.GyroWalk"))
        s.walk_acc = float(_req(d, "IMU.AccWalk"))
        s.imu_freq = float(_req(d, "IMU.Frequency"))
        s.T_bc = _read_mat(d, "IMU.T_b_c1")
        s.insert_kfs_when_lost = bool(_opt(d, "IMU.InsertKFsWhenLost", 1))
    s.n_features = int(_opt(d, "ORBextractor.nFeatures", 1200))
    s.n_levels = int(_opt(d, "ORBextractor.nLevels", 8))
    s.scale_factor = float(_opt(d, "ORBextractor.scaleFactor", 1.2))
    s.fast_th = int(_opt(d, "ORBextractor.iniThFAST", 20))
    s.fast_th_min = int(_opt(d, "ORBextractor.minThFAST", 7))
    s.load_file = str(_opt(d, "System.LoadAtlasFromFile", "") or "")
    s.save_file = str(_opt(d, "System.SaveAtlasToFile", "") or "")
    return s
