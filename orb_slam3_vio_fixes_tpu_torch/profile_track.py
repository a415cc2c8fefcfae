"""Where the time goes on the card: per-stage host times and a
torch.profiler kernel table for the bench scenario in sync mode.

    python -m orb_slam3_vio_fixes_tpu_torch.profile_track [--frames 80]

Pass 1 warms up (kernel build, allocator); pass 2 times every stage with a
device synchronise on both sides (so the stages add up to the frame time,
and profiling slows the run a little); pass 3 runs the last frames under
torch.profiler and prints the device kernels by total time, the device busy
time and the idle share of the window. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import functools
import time

import numpy as np
import torch

from orb_slam3_vio_fixes_tpu_torch.frontend import tracking


def _timed(times, name, fn):
    @functools.wraps(fn)
    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
        return out
    return wrapper


def main() -> None:
    import chip_smoke  # the bench scenario and tracker (repository root)

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--window", type=int, default=20,
                    help="frames profiled by torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_track: no CUDA device")
    dev = torch.device("cuda")
    seq = chip_smoke.make_sequence(args.frames)
    chip_smoke.run_pass(seq, dev)                        # warm-up

    times = collections.defaultdict(list)
    stages = {
        "frame_build": "build_stereo_frame_impl", "track_step": "track_step_impl",
        "track_reference_kf": "track_reference_kf", "kf_create_map": "kf_create_map",
        "kf_local_ba": "kf_ba_stage"}
    saved = {n: getattr(tracking, n) for n in stages.values()}
    saved_cull = tracking.StereoTracker._kf_stage_cull
    try:
        for label, name in stages.items():
            setattr(tracking, name, _timed(times, label, saved[name]))
        tracking.StereoTracker._kf_stage_cull = _timed(times, "kf_cull", saved_cull)
        tr, per_frame = chip_smoke.run_pass(seq, dev)
    finally:
        for name, fn in saved.items():
            setattr(tracking, name, fn)
        tracking.StereoTracker._kf_stage_cull = saved_cull
    total = sum(per_frame[1:])
    print(f"[stages] frames={args.frames} keyframes={len(tr.kf_order)} "
          f"wall_s={total:.3f} (first frame excluded)")
    for label, ts in times.items():
        ts = np.asarray(ts) * 1e3
        print(f"[stages] {label}: calls={len(ts)} mean_ms={ts.mean():.3f} "
              f"p50_ms={np.percentile(ts, 50):.3f} total_s={ts.sum() / 1e3:.3f}")

    from torch.profiler import ProfilerActivity, profile

    tr = chip_smoke.build_tracker(seq, dev)
    n = seq.imgs_l.shape[0]
    start = max(1, n - args.window)
    for i in range(start):
        tr.process_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(start, n):
            tr.process_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and getattr(e, "device_time_total", 0) > 0]
    busy_us = sum(e.device_time_total for e in events)
    n_launch = sum(e.count for e in events)
    print(f"[profile] frames={n - start} wall_s={wall:.3f} device_busy_s={busy_us / 1e6:.3f} "
          f"idle_share={1 - busy_us / 1e6 / wall:.3f} kernel_launches={n_launch} "
          f"launches_per_frame={n_launch / (n - start):.0f}")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:25]:
        print(f"[profile] {e.device_time_total / 1e3:9.3f} ms  calls={e.count:6d}  {e.key[:90]}")


if __name__ == "__main__":
    main()
