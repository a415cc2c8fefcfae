"""Read the gated values of the phases that run a window VI BA (7, 12-15,
17, 19) and of phase 20 out of chip_smoke.py logs, one column per log.

    python -m orb_slam3_vio_fixes_tpu_torch.gated_values LOG [LOG ...]

Prints a markdown table, and for each row whether every log agrees. A
value a log does not hold prints as "-".
"""

from __future__ import annotations

import re
import sys

NUM = r"([-+0-9.eE]+|True|False)"

# (label, line prefix, pattern of the value in that line, which match)
ROWS = (
    ("7 stereo-inertial ATE m", "[inertial] frames=", r"ate_rmse_m=" + NUM, 0),
    ("7 final speed", "[inertial] frames=", r"speed_est=" + NUM, 0),
    ("12 SI loop ATE m", "[si_loop] with the closer", r"ate_rmse_m=" + NUM, 0),
    ("12 corrections", "[si_loop] with the closer", r"corrections=" + NUM, 0),
    ("12 gravity median deg", "[si_loop] with the closer", r"gravity_deg_median=" + NUM, 0),
    ("12 gravity max deg", "[si_loop] with the closer", r"gravity_deg_max=" + NUM, 0),
    ("12 velocity rel err", "[si_loop] with the closer", r"velocity_rel_err=" + NUM, 0),
    ("12 without closer ATE m", "[si_loop] without the closer", r"ate_rmse_m=" + NUM, 0),
    ("12 sharded VI GBA kf_t max m", "[si_loop]", r"kf_t_max_diff_m=" + NUM, 0),
    ("12 sharded VI GBA lm median m", "[si_loop]", r"landmark_median_m=" + NUM, 0),
    ("13 reloc centre m", "[si_atlas] plan", r"centre_err_m=" + NUM, 0),
    ("13 merge centre m", "[si_atlas] plan", r"centre_err_m=" + NUM, 1),
    ("14 IMU_STEREO ATE m", "[facade] IMU_STEREO:", r"ate_rmse_m=" + NUM, 0),
    ("14 IMU_RGBD ATE m", "[facade] IMU_RGBD:", r"ate_rmse_m=" + NUM, 0),
    ("14 IMU_MONOCULAR ATE m", "[facade] IMU_MONOCULAR:", r"ate_rmse_m=" + NUM, 0),
    ("15 app ATE m", "[app] main_template", r"ate_rmse_m=" + NUM, 0),
    ("17 mono-inertial ATE m", "[mono_inertial] imu_ready", r"keyframe\)=" + NUM, 0),
    ("17 Horn scale", "[mono_inertial] imu_ready", r"horn_scale=" + NUM, 0),
    ("19 fisheye IMU_STEREO ATE m", "[fisheye] IMU_STEREO:", r"ate_rmse_m=" + NUM, 0),
    ("20 mesh loop ATE m", "[mesh] loop on", r"ate_rmse_m=" + NUM, 0),
    ("20 corrections", "[mesh] loop on", r"corrections=" + NUM, 0),
    ("20 sharded vs unsharded centre m", "[mesh]", r"centre_max_m=" + NUM, 0),
    ("20 sharded vs unsharded lm median m", "[mesh]", r"[^_]landmark_median_m=" + NUM, 0),
    ("20 sharded GBA byte-identical", "[mesh]", r"byte-identical=" + NUM, 0),
    ("20 reloc n_success_global", "[mesh] reloc on", r"n_success_global=" + NUM, 0),
    ("20 reloc centre m", "[mesh] reloc on", r"centre_err_m=" + NUM, 0),
    ("20 dryrun parity", "dryrun_multichip(4) realistic", r"parity=([0-9]+/[0-9]+)", 0),
)


def read(path: str) -> dict:
    lines = open(path, errors="replace").read().splitlines()
    out = {}
    for label, prefix, pattern, which in ROWS:
        found = [m.group(1) for line in lines if line.startswith(prefix) or
                 (prefix.startswith("dryrun") and prefix in line)
                 for m in re.finditer(pattern, line)]
        if len(found) > which:
            out[label] = found[which]
    return out


def main(argv=None) -> int:
    paths = list(sys.argv[1:] if argv is None else argv)
    if not paths:
        raise SystemExit(__doc__)
    cols = [read(p) for p in paths]
    print("| value | " + " | ".join(paths) + " | same |")
    print("| --- |" + " --- |" * (len(paths) + 1))
    for label, *_ in ROWS:
        vals = [c.get(label, "-") for c in cols]
        print(f"| {label} | " + " | ".join(vals) + f" | {len(set(vals)) == 1} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
