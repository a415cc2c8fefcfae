"""The port's app runners (orb_slam3_vio_fixes_tpu_torch/apps.py and its
example modules) against the JAX package's: the twins of tests/test_apps.py
on the same EuRoC-layout directory (tests/test_apps.py's `disk_seq`: 6
frames of 352x240 stereo).

Tolerances:
- run_sequence("euroc", "STEREO") through the YAML, the directory, the
  PipelineRunner, a loopback MAVLink link and the offline viewer: the same
  n_frames, n_keyframes and final_state as the JAX run_sequence with the same
  configuration, the TUM file's ATE within 1.5x + 5 mm of the JAX file's;
- run_multisession over two sessions: both sessions' frames exported;
- the device: run_sequence and run_multisession run on the card by default
  and raise without CUDA; the command line has no device option.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu import apps as japps
from orb_slam3_vio_fixes_tpu.frontend import tracking as jtr
from orb_slam3_vio_fixes_tpu.ops import orb as jorb
from orb_slam3_vio_fixes_tpu.slam_map import map_state as jms
from orb_slam3_vio_fixes_tpu_torch import apps
from orb_slam3_vio_fixes_tpu_torch.evaluation import ate

from test_apps import disk_seq  # noqa: F401  (fixture)
from test_torch_slice import port_cfg

pytest_plugins = ["torch_jax_release"]
# every thread a test starts (shards, decoder, interface loops) ends with it
pytestmark = pytest.mark.usefixtures("threads_end")

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tracker_cfg():
    map_cfg = jms.MapConfig(max_keyframes=8, max_landmarks=2048, max_features=320,
                            n_levels=4)
    return jtr.TrackerConfig(
        orb=jorb.ORBConfig(n_features=320, n_levels=4), map=map_cfg, width=352,
        height=240, max_local_lm=512, ba_window=4, ba_fixed=2, new_lm_budget=128,
        max_frames_between_kf=6)


def file_ate(path, sseq):
    """ATE of a TUM trajectory file against the sequence's camera centres
    (the directory's stamps start at 1 s)."""
    rows = np.loadtxt(path, ndmin=2)
    rmse, _, n = ate.ate_rmse(1.0 + sseq.ts, sseq.t_wc, rows[:, 0], rows[:, 1:4])
    assert n == len(sseq.ts)
    return rmse


@pytest.fixture(scope="module")
def jax_run(disk_seq, tmp_path_factory):  # noqa: F811
    root, yaml_path, _ = disk_seq
    out = str(tmp_path_factory.mktemp("jax") / "traj.txt")
    cfg = jax_tracker_cfg()
    summary = japps.run_sequence("euroc", "STEREO", yaml_path, root, out,
                                 map_cfg=cfg.map, tracker_cfg=cfg,
                                 mavlink_cfg={"mode": "odometry"})
    return summary, out


def test_run_sequence_like_reference(disk_seq, jax_run, tmp_path):  # noqa: F811
    root, yaml_path, sseq = disk_seq
    ref, ref_out = jax_run
    out = str(tmp_path / "traj.txt")
    cfg = port_cfg(jax_tracker_cfg())
    summary = apps.run_sequence(
        "euroc", "STEREO", yaml_path, root, out, map_cfg=cfg.map, tracker_cfg=cfg,
        viz_dir=str(tmp_path / "viz"), mavlink_cfg={"mode": "odometry"}, device="cpu")
    for key in ("n_frames", "n_keyframes", "final_state"):
        assert summary[key] == ref[key], key
    assert summary["n_frames"] == 6 and summary["final_state"] == "OK"
    assert set(summary["stage_times"]) == {"decode", "track"}
    lines = [ln for ln in open(out) if ln.strip()]
    assert len(lines) == 6 and len(lines[0].split()) == 8      # TUM format
    for name in ("map.png", "trajectory.png"):
        assert os.path.exists(tmp_path / "viz" / name)
    got, bar = file_ate(out, sseq), 1.5 * file_ate(ref_out, sseq) + 0.005
    assert got <= bar, (got, bar)


def test_run_multisession(disk_seq, tmp_path):  # noqa: F811
    """Two sessions through one system and Atlas; the fallback vocabulary is
    trained from the first frame's features (the port's extractor)."""
    root, yaml_path, _ = disk_seq
    out = str(tmp_path / "multi.txt")
    summary = apps.run_multisession("euroc", "STEREO", yaml_path, [root, root], out,
                                    device="cpu")
    assert len(summary["sessions"]) == 2
    assert [s["n_frames"] for s in summary["sessions"]] == [6, 6]
    lines = [ln for ln in open(out) if ln.strip()]
    assert len(lines) == 12


def test_runners_default_to_the_card(disk_seq, tmp_path, monkeypatch):  # noqa: F811
    root, yaml_path, _ = disk_seq
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "t.txt")
    with pytest.raises(RuntimeError, match="CUDA"):
        apps.run_sequence("euroc", "STEREO", yaml_path, root, out)
    with pytest.raises(RuntimeError, match="CUDA"):
        apps.run_multisession("euroc", "STEREO", yaml_path, [root], out)
    assert not os.path.exists(out)


@pytest.mark.parametrize("module", ["euroc_stereo", "stereo_inertial_vio", "euroc_mono",
                                    "tum_mono", "tum_vi_stereo_inertial"])
def test_example_modules_parse(module):
    r = subprocess.run(
        [sys.executable, "-m", f"orb_slam3_vio_fixes_tpu_torch.examples.{module}", "-h"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "settings" in r.stdout and "--vio-config" in r.stdout
    assert "--device" not in r.stdout
