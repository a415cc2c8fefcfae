"""Shared CLI runner behind the example apps (port of
orb_slam3_vio_fixes_tpu/apps.py).

Reference semantics: each Examples/*/<app>.cc is main() = load dataset →
construct System → per-frame Track* loop with timing → SaveTrajectory*
(e.g. Examples/Stereo-Inertial/stereo_inertial_euroc.cc). Here one generic
runner covers all dataset/sensor combinations; the thin modules in
`examples/` mirror the reference's per-app entry points.

`run_sequence` and `run_multisession` run on the card unless the caller
passes `device="cpu"`, and raise when CUDA is absent (through the facade);
the command line has no device option. Both switch PyTorch to deterministic
algorithms first (`utils/determinism.py`).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np
import torch

from orb_slam3_vio_fixes_tpu_torch.io import datasets
from orb_slam3_vio_fixes_tpu_torch.io.settings import load_settings
from orb_slam3_vio_fixes_tpu_torch.ops import orb
from orb_slam3_vio_fixes_tpu_torch.runtime import PipelineRunner
from orb_slam3_vio_fixes_tpu_torch.sensors import Sensor
from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary as voc
from orb_slam3_vio_fixes_tpu_torch.system import SLAMSystem, _device
from orb_slam3_vio_fixes_tpu_torch.utils import determinism
from orb_slam3_vio_fixes_tpu_torch.vio import (
    GPSCoord, LoopbackTransport, MAVLinkInterface, TxMode, UARTTransfer)


def _load(dataset: str, sensor: Sensor, seq_dir: str, timestamps=None,
          associations=None) -> datasets.SequenceIndex:
    if dataset in ("euroc", "tumvi"):
        return datasets.load_euroc(seq_dir, timestamps_file=timestamps,
                                   stereo=sensor.is_stereo, with_imu=sensor.has_imu)
    if dataset == "kitti":
        return datasets.load_kitti(seq_dir, stereo=sensor.is_stereo)
    if dataset == "tum_rgbd":
        return (datasets.load_tum_rgbd(seq_dir, associations_file=associations)
                if sensor.is_rgbd else datasets.load_tum_mono(seq_dir))
    raise ValueError(f"unknown dataset {dataset}")


def _saver(slam: SLAMSystem, traj_format: str):
    return {
        "tum": slam.save_trajectory_tum,
        "euroc": slam.save_trajectory_euroc,
        "kitti": slam.save_trajectory_kitti,
    }[traj_format]


def _mavlink(cfg: dict) -> MAVLinkInterface:
    """The fork's JSON config → a MAVLinkInterface over UART, or over the
    loopback when no port is given or it cannot be opened."""
    port = cfg.get("port")
    transport = LoopbackTransport()
    if port:
        uart = UARTTransfer(port, cfg.get("baudrate", 115200))
        if uart.connect():
            transport = uart
        else:
            print(f"[vio] could not open {port}; using loopback", file=sys.stderr)
    origin = None
    if "gps_origin" in cfg:
        o = cfg["gps_origin"]
        origin = GPSCoord(o["lat"], o["lon"], o["alt"])
    return MAVLinkInterface(transport, mode=TxMode(cfg.get("mode", "odometry")),
                            gps_origin=origin)


def run_sequence(
    dataset: str,
    sensor_name: str,
    settings_path: str,
    seq_dir: str,
    out_traj: str,
    timestamps: Optional[str] = None,
    associations: Optional[str] = None,
    max_frames: Optional[int] = None,
    traj_format: str = "tum",
    viz_dir: Optional[str] = None,
    mavlink_cfg: Optional[dict] = None,
    vocab_path: Optional[str] = None,
    map_cfg=None,
    tracker_cfg=None,
    device="cuda",
) -> dict:
    determinism.enable()        # before any CUDA work: the cuBLAS workspace
    dev = _device(device)
    sensor = Sensor[sensor_name]
    seq = _load(dataset, sensor, seq_dir, timestamps, associations)
    # no vocabulary without --vocab: no place recognition, as in the reference
    vocab = voc.load(vocab_path, dev) if vocab_path else None

    settings = load_settings(settings_path, sensor)
    slam = SLAMSystem(settings, sensor, vocab=vocab, map_cfg=map_cfg,
                      tracker_cfg=tracker_cfg, device=dev)
    mavlink = _mavlink(mavlink_cfg) if mavlink_cfg else None

    runner = PipelineRunner(slam, seq, mavlink=mavlink, max_frames=max_frames)
    res = runner.run()
    if mavlink is not None:
        mavlink.drain()
    _saver(slam, traj_format)(out_traj)

    summary = {
        "n_frames": res.n_frames,
        "fps": round(res.fps, 2),
        "n_keyframes": slam.n_keyframes(),
        "n_landmarks": slam.n_landmarks(),
        "final_state": str(slam.get_tracking_state()),
        "stage_times": res.times.summary(),
        "trajectory": out_traj,
    }
    if viz_dir:
        from orb_slam3_vio_fixes_tpu_torch.viz import OfflineViewer

        viewer = OfflineViewer(viz_dir)
        viewer.finalize(map_state=slam.tracker.state, trajectory=res.trajectory)
        summary["viz_dir"] = viz_dir
    return summary


def run_multisession(
    dataset: str,
    sensor_name: str,
    settings_path: str,
    seq_dirs: list,
    out_traj: str,
    timestamps: Optional[list] = None,
    max_frames: Optional[int] = None,
    traj_format: str = "tum",
    vocab_path: Optional[str] = None,
    device="cuda",
) -> dict:
    """Multi-session SLAM: several sequences through ONE system.

    Reference semantics: the example binaries accept multiple
    (sequence, timestamps) pairs and call System::ChangeDataset between them
    (e.g. Examples/Stereo-Inertial/stereo_inertial_euroc.cc main loop) — the
    tracker loses the map at the seam, spawns a fresh map in the Atlas
    (Tracking::CreateMapInAtlas, src/Tracking.cc:2662), and place recognition
    merges the sessions when revisiting (LoopClosing::MergeLocal).

    Requires a vocabulary; if none is given, a small one is trained on the
    first sequence's first frame (self-contained default for experiments).
    """
    determinism.enable()        # before any CUDA work: the cuBLAS workspace
    dev = _device(device)
    sensor = Sensor[sensor_name]
    if dataset not in ("euroc", "tumvi", "kitti"):
        raise ValueError(f"multisession supports euroc/tumvi/kitti, got {dataset}")
    seqs = [_load(dataset, sensor, d, timestamps[i] if timestamps else None)
            for i, d in enumerate(seq_dirs)]

    if vocab_path:
        vocab = voc.load(vocab_path, dev)
    else:
        # the frame's features through the device extractor (K1 on the card)
        img0 = torch.as_tensor(np.asarray(seqs[0].frame(0)[1], np.float32), device=dev)
        feats = orb.extract_batch(img0[None], orb.ORBConfig(n_features=1000))
        pool = feats.desc[0][feats.valid[0]].cpu().numpy()
        vocab = voc.train(pool, branching=8, depth=2, seed=0, device=dev)

    settings = load_settings(settings_path, sensor)
    slam = SLAMSystem(settings, sensor, vocab=vocab, device=dev)

    per_session = []
    for seq in seqs:
        res = PipelineRunner(slam, seq, max_frames=max_frames).run()
        per_session.append({
            "n_frames": res.n_frames, "fps": round(res.fps, 2),
            "n_keyframes": slam.n_keyframes(),
            "maps_stored": len(slam.atlas.stored) if slam.atlas else 0,
            "n_merges": slam.atlas.n_merges if slam.atlas else 0,
        })
    _saver(slam, traj_format)(out_traj)
    return {
        "sessions": per_session,
        "n_merges": slam.atlas.n_merges if slam.atlas else 0,
        "trajectory": out_traj,
    }


def main_template(dataset: str, sensor_name: str, description: str,
                  argv=None) -> int:
    """argparse main shared by the examples/ modules."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("settings", help="calibration YAML (v1.0 schema)")
    ap.add_argument("seq_dir", help="dataset sequence directory")
    ap.add_argument("out_traj", help="output trajectory file")
    ap.add_argument("--timestamps", default=None,
                    help="EuRoC-style timestamp list file")
    ap.add_argument("--associations", default=None,
                    help="TUM-RGBD associations file")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--format", default="tum",
                    choices=("tum", "euroc", "kitti"))
    ap.add_argument("--viz-dir", default=None)
    ap.add_argument("--vocab", default=None, help="BoW vocabulary .npz")
    ap.add_argument("--vio-config", default=None,
                    help="JSON config enabling MAVLink output (fork layer)")
    args = ap.parse_args(argv)
    mavlink_cfg = None
    if args.vio_config:
        with open(args.vio_config) as f:
            mavlink_cfg = json.load(f)
    summary = run_sequence(
        dataset, sensor_name, args.settings, args.seq_dir, args.out_traj,
        timestamps=args.timestamps, associations=args.associations,
        max_frames=args.max_frames, traj_format=args.format,
        viz_dir=args.viz_dir, mavlink_cfg=mavlink_cfg, vocab_path=args.vocab)
    print(json.dumps(summary, indent=2))
    return 0
