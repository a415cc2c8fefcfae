"""Multi-session stereo EuRoC: several sequences through one Atlas, merged by
place recognition (the reference's multi-sequence example mode, e.g.
Examples/Stereo-Inertial/stereo_inertial_euroc.cc with >1 (path, times) pair
+ LoopClosing::MergeLocal)."""
import argparse
import json

from orb_slam3_vio_fixes_tpu_torch.apps import run_multisession


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("settings", help="calibration YAML (v1.0 schema)")
    ap.add_argument("out_traj", help="output trajectory file")
    ap.add_argument("seq_dirs", nargs="+", help="sequence directories")
    ap.add_argument("--timestamps", nargs="*", default=None,
                    help="per-sequence timestamp files")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--format", default="tum", choices=("tum", "euroc", "kitti"))
    ap.add_argument("--vocab", default=None, help="BoW vocabulary .npz")
    args = ap.parse_args(argv)
    summary = run_multisession(
        "euroc", "STEREO", args.settings, args.seq_dirs, args.out_traj,
        timestamps=args.timestamps, max_frames=args.max_frames,
        traj_format=args.format, vocab_path=args.vocab)
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
