"""Repeat one phase of chip_smoke.py on the card, to see its spread.

    python -m orb_slam3_vio_fixes_tpu_torch.phase_repeat app
    python -m orb_slam3_vio_fixes_tpu_torch.phase_repeat si_atlas [N]

`app`: the facade's direct IMU_STEREO loop (phase 14's frames) and phase 15
(the same frames through apps.main_template and the PipelineRunner) in
turns, direct / app / app / direct / app, each app run printing its frame
median beside the last direct loop's. `si_atlas`: phase 13 N times (default
4), printing the Sim3 gates of every merge verification and whether each run
passed. Needs a CUDA device; ~30 s per app or direct run, ~70-100 s per
si_atlas run.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch


def _app(cs, dev, card) -> None:
    from orb_slam3_vio_fixes_tpu_torch import system as sysm
    from orb_slam3_vio_fixes_tpu_torch.io import synthetic

    frames, _, _ = cs.facade_scenario("IMU_STEREO", synthetic)

    def direct():
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "facade.yaml")
            with open(path, "w") as f:
                f.write(cs.FACADE_YAML)
            per_frame = cs.track_facade(sysm.SLAMSystem(path, sysm.Sensor.IMU_STEREO), frames)
        ms = 1e3 * np.asarray(per_frame)
        print(f"[direct] fps={float(len(ms) / ms.sum() * 1e3)!r} p50={float(np.median(ms))!r} "
              f"max={float(ms.max())!r} sum={float(ms.sum())!r}", flush=True)
        return per_frame

    last = None
    for step in ("direct", "app", "app", "direct", "app"):
        if step == "direct":
            last = direct()
        else:
            cs.app_path(dev, card, {"IMU_STEREO": last})


def _si_atlas(cs, dev, card, n_runs: int) -> None:
    from orb_slam3_vio_fixes_tpu_torch.slam_map import atlas as atlas_mod
    from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary

    vocab = vocabulary.default_vocabulary(dev)
    verify = atlas_mod.verify_cross_candidate

    def logged(*a, **k):
        n_m, n_proj, sim = verify(*a, **k)
        print(f"[merge-verify] kf={a[2]} cand={a[4]} n_m={int(n_m)} n_proj={int(n_proj)} "
              f"n_inliers={int(sim.n_inliers)}", flush=True)
        return n_m, n_proj, sim

    atlas_mod.verify_cross_candidate = logged
    try:
        for run in range(n_runs):
            t0 = time.perf_counter()
            try:
                cs.si_atlas_path(vocab, dev, card)
                print(f"[repeat] run {run} passed {time.perf_counter() - t0:.1f}s", flush=True)
            except RuntimeError as e:
                print(f"[repeat] run {run} failed: {e}", flush=True)
    finally:
        atlas_mod.verify_cross_candidate = verify


def main(argv=None) -> int:
    import chip_smoke as cs  # the scenarios, phases and checks (repository root)

    from orb_slam3_vio_fixes_tpu_torch import kernels

    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("app", "si_atlas"):
        raise SystemExit(__doc__)
    card = cs.card_facts()
    print(f"[card] {card}", flush=True)
    kernels.build()
    kernels.library()
    dev = torch.device("cuda")
    if argv[0] == "app":
        _app(cs, dev, card)
    else:
        _si_atlas(cs, dev, card, int(argv[1]) if len(argv) > 1 else 4)
    return 0


if __name__ == "__main__":
    sys.exit(main())
