"""A cell of the benchmark cut to a size the CPU runs in seconds, for the
rehearsals: 256 x 160 pixels, 300 features on 4 levels, a sparser world,
the window's draws within its first frames. `bench` writes the cut files
beside a copy of BENCHMARK.json under a temporary root, as a checkout
holds them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from slam_bench import spec

ROOT = Path(__file__).resolve().parents[2]
CELLS = {"stereo": ("euroc_stereo.explore", "euroc_stereo"),
         "si": ("euroc_si.explore", "euroc_stereo_inertial")}
W, H, FX = 256, 160, 160.0
# the trajectory's and inertial numbers' limits at this size, from sound CPU
# runs (ate_m 0.009, kf_ate_m 0.015-0.027, kf_vel_err 0.11, kf_bg_err 0.014,
# kf_ba_err 0.01, gravity_deg 0.8): 300 features in 256 x 160 track far
# worse than the cells' 1200 in 752 x 480; the exact numbers keep theirs
TINY_LIMITS = {"ate_m": 0.035, "kf_ate_m": 0.05, "kf_vel_err": 0.5, "kf_bg_err": 0.05,
               "kf_ba_err": 0.05, "gravity_deg": 3.0}


def tiny_config(name: str, root: Path) -> dict:
    """The configuration cut to the tiny size, its settings file written
    under `root`."""
    c = json.loads((ROOT / f"slam_bench/configs/{name}.json").read_text())
    y = (ROOT / c["settings"]).read_text()
    cam = c["camera"]
    for key, old, new in (("Camera.width", cam["width"], W), ("Camera.height", cam["height"], H),
                          ("Camera1.fx", cam["fx"], FX), ("Camera1.fy", cam["fy"], FX),
                          ("Camera1.cx", cam["cx"], W / 2), ("Camera1.cy", cam["cy"], H / 2),
                          ("Camera.bf", cam["bf"], FX * cam["baseline"]),
                          ("ORBextractor.nFeatures", c["orb"]["nFeatures"], 300),
                          ("ORBextractor.nLevels", c["orb"]["nLevels"], 4)):
        line = f"{key}: {old}"
        if line not in y:
            raise AssertionError(f"{line!r} not in {c['settings']}")
        y = y.replace(line, f"{key}: {new}")
    (root / c["settings"]).write_text(y)
    c["camera"].update(width=W, height=H, fx=FX, fy=FX, cx=W / 2, cy=H / 2,
                       bf=FX * cam["baseline"])
    c["orb"].update(nFeatures=300, nLevels=4)
    return c


def tiny_traffic(name: str) -> dict:
    t = json.loads((ROOT / f"slam_bench/traffic/{name}.json").read_text())
    t["warmup"].update(frames=12, after_imu_init=1, max_frames=40)
    for g in t["world"]:
        g["per_anchor"] = 15
    t["check"].update(frames_within=4, k2_within=10)
    t["trace"].update(sync_frames=2, profile_frames=2, gap_frames=1)
    return t


def bench(which: str, root: Path, limits: dict | None = None, max_fps: float = 4) -> tuple:
    """(Bench over `root`, cell name): the committed BENCHMARK.json and
    readers, with the cell's configuration and traffic cut to the tiny size,
    its committed limits with TINY_LIMITS for the numbers that have one,
    unless `limits` is given, and `max_fps`."""
    cell, cfg = CELLS[which]
    d = Path(root) / "slam_bench"
    for sub in ("configs", "traffic", "cells"):
        (d / sub).mkdir(parents=True, exist_ok=True)
    if not (d / "metrics").exists():
        shutil.copytree(ROOT / "slam_bench/metrics", d / "metrics",
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", Path(root) / "BENCHMARK.json")
    (d / f"configs/{cfg}.json").write_text(json.dumps(tiny_config(cfg, Path(root))))
    traffic = spec.Bench(ROOT).cell(cell)["traffic"]
    (d / f"traffic/{traffic}.json").write_text(json.dumps(tiny_traffic(traffic)))
    c = spec.Bench(ROOT).cell_file(cell)
    c["max_fps"] = max_fps
    c["limits"] = limits if limits is not None else {
        k: TINY_LIMITS.get(k, v) for k, v in c["limits"].items()}
    (d / f"cells/{cell}.json").write_text(json.dumps(c))
    return spec.Bench(root), cell


def no_limits(cell: str) -> dict:
    """The cell's numbers, none of them held."""
    return {k: float("inf") for k in spec.Bench(ROOT).cell_file(cell)["limits"]}
