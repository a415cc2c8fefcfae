"""Where the time goes on the card: per-stage host times, a torch.profiler
kernel table and the stream syncs, for the stereo bench scenario or (with
--inertial) the stereo-inertial one, in sync mode.

    python -m orb_slam3_vio_fixes_tpu_torch.profile_track [--frames 80]
    python -m orb_slam3_vio_fixes_tpu_torch.profile_track --inertial [--frames 60]

Pass 1 warms up (kernel build, allocator, library handles); pass 2 times
every stage with a device synchronise on both sides (so the stages add up to
the frame time, and profiling slows the run a little); pass 3 runs the last
frames under torch.profiler and prints the device kernels by total time,
the device busy time, the idle share of the window and the kernel launches
per frame, overall and inside each stage; with --inertial, the host cost
of the per-frame `eigh` shapes, and pass 4 counts the stream syncs per
frame and where they come from (torch.cuda.set_sync_debug_mode). Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import time
import traceback
import warnings

import numpy as np
import torch

from orb_slam3_vio_fixes_tpu_torch.frontend import inertial_tracking as it
from orb_slam3_vio_fixes_tpu_torch.frontend import tracking
from orb_slam3_vio_fixes_tpu_torch.optim import vi_global_ba as vg

STEREO_STAGES = [
    (tracking, "build_stereo_frame_impl", "frame_build"),
    (tracking, "track_step_impl", "track_step"),
    (tracking, "track_reference_kf", "track_reference_kf"),
    (tracking, "kf_create_map", "kf_create_map"),
    (tracking, "kf_ba_stage", "kf_local_ba"),
    (tracking.StereoTracker, "_kf_stage_cull", "kf_cull")]
INERTIAL_STAGES = STEREO_STAGES + [
    (it, "vi_track_step", "vi_track_step"),
    (it, "inertial_local_ba", "inertial_local_ba"),
    (it.StereoInertialTracker, "_initialize_imu", "imu_init (incl. both VI BAs)"),
    (vg, "run_global_vi_ba", "full_vi_ba")]


STAGE = "stage: "


def _timed(times, name, fn, sync):
    @functools.wraps(fn)
    def wrapper(*a, **k):
        with torch.profiler.record_function(STAGE + name):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
        return out
    return wrapper


@contextlib.contextmanager
def stage_timers(stages, sync: bool = True):
    """Patch each (owner, attribute) with a host timer, synchronised on both
    sides unless `sync` is off, inside a profiler range named after the
    stage; yields {label: [seconds, ...]}."""
    times = collections.defaultdict(list)
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in stages]
    try:
        for (owner, name, fn), (_, _, label) in zip(saved, stages):
            setattr(owner, name, _timed(times, label, fn, sync))
        yield times
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def print_stages(times, prefix: str = "[stages]") -> None:
    for label, ts in times.items():
        ts = np.asarray(ts) * 1e3
        print(f"{prefix} {label}: calls={len(ts)} mean_ms={ts.mean():.3f} "
              f"p50_ms={np.percentile(ts, 50):.3f} max_ms={ts.max():.3f} "
              f"total_s={ts.sum() / 1e3:.3f}", flush=True)


def device_profile(step, frames, top: int = 25, prefix: str = "[profile]",
                   by_stage: bool = True) -> dict:
    """Run step(i) for each frame under torch.profiler; print the device
    busy time, idle share, launches per frame and the top kernels, and with
    `by_stage` the launches per call of each `stage_timers` stage (which
    records every host op too, and slows the profiled run and its
    post-processing)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if by_stage else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in frames:
            step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device kernels and copies; the stage ranges' device-side annotations
    # would count their kernels twice
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and getattr(e, "device_time_total", 0) > 0
              and not e.key.startswith(STAGE)]
    busy_s = sum(e.device_time_total for e in events) / 1e6
    n_launch = sum(e.count for e in events)
    out = {"frames": len(frames), "wall_s": wall, "device_busy_s": busy_s,
           "idle_share": 1 - busy_s / wall, "kernel_launches": n_launch,
           "launches_per_frame": n_launch / len(frames)}
    print(f"{prefix} " + " ".join(f"{k}={v!r}" for k, v in out.items()), flush=True)
    for e in sorted(events, key=lambda e: -e.device_time_total)[:top]:
        print(f"{prefix} {e.device_time_total / 1e3:9.3f} ms  calls={e.count:6d}  "
              f"{e.key[:90]}", flush=True)
    for label, (calls, n) in (stage_launches(prof) if by_stage else {}).items():
        print(f"{prefix} launches per call of {label}: {n / calls:.0f} "
              f"(calls={calls}, nested stages included)", flush=True)
    return out


def stage_launches(prof) -> dict:
    """{stage label: (calls, device kernels launched inside)} from the
    stage ranges of `stage_timers`."""
    def kernels_under(e):
        return len(e.kernels) + sum(kernels_under(c) for c in e.cpu_children)

    out = {}
    for e in prof.events():
        # the host-side range (its device-side annotation holds no kernels)
        if e.name.startswith(STAGE) and str(e.device_type).endswith("CPU"):
            calls, n = out.get(e.name[len(STAGE):], (0, 0))
            out[e.name[len(STAGE):]] = (calls + 1, n + kernels_under(e))
    return out


def eigh_cost(prefix: str = "[eigh]") -> None:
    """Host ms per call of the per-frame `eigh` shapes, which synchronise
    the stream (their error check), beside `cholesky_ex` of the same
    shapes, which does not."""
    dev = torch.device("cuda")
    for batch, n in ((1, 15), (1, 9), (1, 6), (8, 9)):
        A = torch.randn(batch, n, n, device=dev)
        A = A @ A.transpose(-1, -2) + n * torch.eye(n, device=dev)
        row = []
        for name, fn in (("eigh", torch.linalg.eigh),
                         ("cholesky_ex", torch.linalg.cholesky_ex)):
            fn(A)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn(A)
            torch.cuda.synchronize()
            row.append(f"{name}={1e3 * (time.perf_counter() - t0) / 200:.4f}")
        print(f"{prefix} ({batch}, {n}, {n}) host ms per call: {' '.join(row)}",
              flush=True)


def sync_sites(step, frames, prefix: str = "[syncs]") -> float:
    """Count the stream syncs that step(i) makes per frame, by the line of
    the package that made them; returns the syncs per frame."""
    sites = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        own = [f for f in traceback.extract_stack()[:-1]
               if "orb_slam3_vio_fixes_tpu_torch" in f.filename
               and "profile_track" not in f.filename]
        f = own[-1] if own else None
        sites[f"{f.filename.split('orb_slam3_vio_fixes_tpu_torch/')[-1]}:"
              f"{f.lineno} {f.name}" if f else "outside the package"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in frames:
                step(i)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n = len(frames)
    print(f"{prefix} frames={n} syncs={sum(sites.values())} "
          f"per_frame={sum(sites.values()) / n:.2f}", flush=True)
    for site, c in sites.most_common():
        print(f"{prefix} {c / n:8.2f} per frame  {site}", flush=True)
    return sum(sites.values()) / n


def main() -> None:
    import chip_smoke  # the bench scenarios and trackers (repository root)

    ap = argparse.ArgumentParser()
    ap.add_argument("--inertial", action="store_true",
                    help="the stereo-inertial scenario (default: stereo)")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--window", type=int, default=20,
                    help="frames profiled by torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_track: no CUDA device")
    dev = torch.device("cuda")
    if args.inertial:
        seq = chip_smoke.make_inertial_sequence(args.frames or chip_smoke.VI_FRAMES)
        build, run, stages = (chip_smoke.build_inertial_tracker,
                              chip_smoke.run_inertial_pass, INERTIAL_STAGES)
    else:
        seq = chip_smoke.make_sequence(args.frames or chip_smoke.N_FRAMES)
        build, run, stages = (chip_smoke.build_tracker, chip_smoke.run_pass,
                              STEREO_STAGES)
    run(seq, dev)                                    # warm-up
    with stage_timers(stages) as times:
        tr, per_frame = run(seq, dev)
    print(f"[stages] frames={len(per_frame)} keyframes={len(tr.kf_order)} "
          f"wall_s={sum(per_frame[1:]):.3f} (first frame excluded)")
    print_stages(times)

    tr = build(seq, dev)
    n = seq.imgs_l.shape[0]
    start = max(1, n - args.window)
    step = functools.partial(chip_smoke.track_frame, tr, seq)
    for i in range(start):
        step(i)
    with stage_timers(stages, sync=False):
        device_profile(step, range(start, n))
    if args.inertial:
        eigh_cost()
        tr = build(seq, dev)
        step = functools.partial(chip_smoke.track_frame, tr, seq)
        for i in range(start):
            step(i)
        sync_sites(step, range(start, n))


if __name__ == "__main__":
    main()
