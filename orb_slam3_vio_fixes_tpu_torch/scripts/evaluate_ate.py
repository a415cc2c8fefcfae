"""RMS ATE evaluation CLI (the port's twin of scripts/evaluate_ate.py).

Usage:
    python -m orb_slam3_vio_fixes_tpu_torch.scripts.evaluate_ate \
        GROUNDTRUTH ESTIMATE [--scale] [--max-dt 0.02] [--verbose]

Both files in TUM format (`ts x y z qx qy qz qw`; '#' comments ignored;
commas read as spaces, so EuRoC's ground-truth CSV reads too, its
nanosecond stamps rescaled to seconds). Prints RMS ATE in metres (and the
Horn-optimal scale with --scale, the monocular variant). Host numpy only.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from orb_slam3_vio_fixes_tpu_torch.evaluation import ate


def load_tum(path):
    """(stamps in s, (N, 3) positions) of a TUM or EuRoC trajectory file."""
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.strip().replace(",", " ")
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            if len(vals) >= 4:
                rows.append(vals[:4])
    arr = np.asarray(rows)
    ts = arr[:, 0]
    # EuRoC ground-truth stamps are in ns
    if ts.max() > 1e14:
        ts = ts * 1e-9
    return ts, arr[:, 1:4]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("groundtruth")
    ap.add_argument("estimate")
    ap.add_argument("--scale", action="store_true",
                    help="optimize alignment scale (monocular)")
    ap.add_argument("--max-dt", type=float, default=0.02)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    ts_gt, p_gt = load_tum(args.groundtruth)
    ts_es, p_es = load_tum(args.estimate)
    rmse, scale, n = ate.ate_rmse(ts_gt, p_gt, ts_es, p_es, with_scale=args.scale,
                                  max_dt=args.max_dt)
    if n < 3:
        print("error: fewer than 3 associated pairs", file=sys.stderr)
        return 1
    if args.verbose:
        print(f"compared_pose_pairs {n} pairs")
        if args.scale:
            print(f"alignment_scale {scale:.6f}")
    print(f"absolute_translational_error.rmse {rmse:.6f} m")
    return 0


if __name__ == "__main__":
    sys.exit(main())
