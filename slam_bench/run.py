"""Run one cell of the benchmark once.

    python -m slam_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with a CUDA card. The cell's scene
is made on the card from the seed and held on the host as uint8 stereo pairs
(`scene.py`); the SLAM package's facade, `SLAMSystem.track_stereo`, is built
from the configuration's settings file with its own defaults (sync mode,
deterministic mode, the loop closer, relocaliser and Atlas on the default
10^5-word vocabulary) and whatever the cell's `facade` options set, and
warmed up on the scene's first frames. Then the window: each frame goes to
`track_stereo` as soon as the previous frame's pose is on the host (a
closed loop); the window closes when the frame that is in flight at
`--seconds` has its pose.

With `--trace 0` the result line carries the cell's end-to-end metrics:
`tracked_fps` (the window's frames over its length),
`frame_ms_p95` (95th percentile of the frames' latencies, from handing the
images over to the pose on the host) where the cell lists it, and `setup_s`
(process start to the window's start: imports, scene, facade, vocabulary,
kernel build on a first run, warm-up). With `--trace 1` the window is
instrumented in stretches (synchronised spans, a count of stream syncs, a
device profile, a host-and-device timeline of the idle gaps) and the line
carries the cell's per-layer metrics, read by `metrics/<name>.py`.

Either way, once the window has closed and the program is freed, what the
window produced is held against the references (`check.py`), and each
number is printed beside its limit. The last line of standard output is the
result's JSON object; a run without a card, or that finds JAX loaded,
prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# cuBLAS needs its deterministic workspace before the first handle is made;
# the facade switches PyTorch to deterministic algorithms and checks it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
# one process with one host thread per library: the host is shared with the
# card's other work, and thread pools only add noise to the host's clock
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from slam_bench import check, scene, spec, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam3_vio_fixes_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Run:
    """One cell's facade over its scene; `step(i)` tracks window frame i."""

    def __init__(self, bench: spec.Bench, cell: dict, seed: int, seconds: float, device):
        from orb_slam3_vio_fixes_tpu_torch.system import Sensor, SLAMSystem

        self.config = bench.config(cell["config"])
        self.traffic = bench.traffic(cell["traffic"])
        self.cell = bench.cell_file(cell["name"])
        self.device = torch.device(device)
        t0 = time.perf_counter()
        self.scene = scene.make(self.traffic, self.config, seed, seconds,
                                self.cell["max_fps"], self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        self.slam = SLAMSystem(str(bench.root / self.config["settings"]),
                               Sensor[self.config["sensor"]],
                               vocab=self.config.get("vocabulary", "default"), device=device)
        for attr, value in self.cell["facade"].get("set", {}).items():
            *path, name = attr.split(".")
            owner = self.slam
            for p in path:
                owner = getattr(owner, p)
            setattr(owner, name, value)
        self.times = {"imports_s": t0 - T_START, "scene_s": t1 - t0,
                      "facade_s": time.perf_counter() - t1}
        self.w0 = None
        self.poses = []
        self.recorder = None

    def track(self, k: int):
        s = self.scene
        if k >= len(s.ts):
            raise RuntimeError(f"the scene ran out of frames at frame {k}: the run outlasted "
                               f"{self.cell['max_fps']} fps")
        imu = s.imu[k] if s.imu is not None else None
        return self.slam.track_stereo(s.imgs[k, 0], s.imgs[k, 1], float(s.ts[k]), imu)

    def warm_up(self) -> None:
        """The scene's first `warmup.frames` frames; a tracker with an IMU
        goes on until its IMU is initialised (with its full-map VI BA) and
        `warmup.after_imu_init` frames more, and fails past
        `warmup.max_frames`. Then the facade's `after_warmup` methods."""
        w = self.traffic["warmup"]
        has_imu = "imu" in self.config
        t0 = time.perf_counter()
        self.imu_ready_at = None
        k = 0
        while k < w["frames"] or (has_imu and (
                self.imu_ready_at is None or k <= self.imu_ready_at + w["after_imu_init"])):
            if k >= w["max_frames"]:
                raise RuntimeError(f"the IMU is not initialised after {k} warm-up frames")
            self.track(k)
            if self.imu_ready_at is None and getattr(self.slam.tracker, "imu_ready", False):
                self.imu_ready_at = k
            k += 1
        self.w0 = k
        for name in self.cell["facade"].get("after_warmup", ()):
            getattr(self.slam, name)()
        _sync(self.device)
        self.times["warmup_s"] = time.perf_counter() - t0

    def step(self, i: int) -> None:
        if self.recorder is not None:
            self.recorder.frame = self.w0 + i
        R, t, state = self.track(self.w0 + i)
        self.poses.append((np.asarray(R, np.float64), np.asarray(t, np.float64), state == "OK"))

    @property
    def corrections(self) -> int:
        lc = self.slam.loop_closer
        return lc.n_corrections if lc is not None else 0


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def timed_window(run: Run, seconds: float) -> tuple:
    """Frames back to back, each started while less than `seconds` have
    passed; the window closes when the last of them has its pose. Returns
    the frames' latencies and the window's length: every frame the window
    started is in both."""
    lat = []
    t0 = f1 = time.perf_counter()
    i = 0
    while f1 - t0 < seconds:
        f0 = time.perf_counter()
        run.step(i)
        f1 = time.perf_counter()
        lat.append(f1 - f0)
        i += 1
    return lat, f1 - t0


def _targets(readers, key: str) -> list:
    """The (module, attribute, label) targets the readers name under `key`,
    each label once."""
    out, seen = [], set()
    for r in readers:
        for tgt in getattr(r, key, ()):
            if tgt[2] not in seen:
                seen.add(tgt[2])
                out.append(tuple(tgt))
    return out


def traced_window(run: Run, seconds: float, readers: list) -> tuple:
    """The instrumented window: synchronised spans (the readers' SPANS) for
    the first `span_share` of it, then stream syncs, a device profile with
    the arguments of the readers' CALLS kept, and an idle-gap timeline, over
    a few frames each. Returns (trace dict, device profile, idle gaps)."""
    tcfg = run.traffic["trace"]
    targets = _targets(readers, "SPANS")
    i = 0
    t0 = time.perf_counter()
    with trace.spans(targets) as times:
        while time.perf_counter() - t0 < seconds * tcfg["span_share"]:
            run.step(i)
            i += 1
    t = {"frames": i, "spans": {k: list(v) for k, v in times.items()}}
    n = tcfg["sync_frames"]
    t["syncs"] = {"frames": n, "count": trace.count_syncs(run.step, range(i, i + n))}
    i += n
    n = tcfg["profile_frames"]
    with trace.calls(_targets(readers, "CALLS")) as calls:
        prof = trace.device_profile(run.step, range(i, i + n))
    prof["calls"] = dict(calls)
    t["profile"] = prof
    i += n
    n = tcfg["gap_frames"]
    gaps = trace.idle_gaps(run.step, range(i, i + n),
                           [("orb_slam3_vio_fixes_tpu_torch.system", "SLAMSystem.track_stereo",
                             "track_stereo")] + targets)
    return t, prof, gaps


def run_cell(bench: spec.Bench, name: str, seed: int, seconds: float, traced: bool,
             device="cuda", control: bool = False) -> dict:
    """One run of cell `name`; the result object (its `checks` last). With
    `control`, the numbers are the control's (check.control_numbers) on the
    same recorded inputs, the run's own are kept under "program", and the
    readings of the faults planted in the truth under "faults"."""
    cell = bench.cell(name)
    dev = torch.device(device)
    run = Run(bench, cell, seed, seconds, dev)
    tr = run.slam.tracker
    c0 = run.corrections
    run.warm_up()
    log(f"[warmup] frames={run.w0} keyframes={len(tr.kf_order)} "
        f"corrections={run.corrections - c0} imu_initialised_after_frame={run.imu_ready_at} "
        + " ".join(f"{k}={v:.3f}" for k, v in run.times.items()))
    chk = run.traffic["check"]
    run.recorder = check.Recorder([run.w0 + j for j in check.draw(seed, chk["frames"],
                                                                  chk["frames_within"])],
                                  check.draw(seed + 1, chk["k2_calls"], chk["k2_within"]))
    c1 = run.corrections
    imu_before = bool(getattr(tr, "imu_ready", False))
    setup_s = time.perf_counter() - T_START
    metrics = {}
    out_device = {}
    breakdown = None
    with run.recorder.installed():
        if traced:
            readers = [bench.reader(m["name"]) for m in bench.per_layer(name)]
            t, prof, gaps = traced_window(run, seconds, readers)
            for r in readers:
                v = r.read(t)
                if v is not None:
                    metrics[r.NAME] = {"value": float(v), "unit": r.UNIT}
            out_device = {"busy_s": prof["busy_s"], "window_s": prof["wall_s"]}
            top = sorted(prof["ops"], key=lambda o: -o[2])[:10]
            breakdown = {"device_ops": [[k, s] for k, _, s in top], "idle_gaps": gaps}
        else:
            lat, length = timed_window(run, seconds)
            e2e = {m["name"]: m for m in bench.end_to_end(name)}
            metrics["tracked_fps"] = {"value": len(lat) / length, "unit": "frames/s"}
            p95 = 1e3 * statistics.quantiles(lat, n=20)[18] if len(lat) >= 2 else float("nan")
            log(f"[window] frames={len(lat)} seconds={length!r} frame_ms "
                f"p50={1e3 * statistics.median(lat)!r} p95={p95!r}")
            if "frame_ms_p95" in e2e:
                metrics["frame_ms_p95"] = {"value": p95, "unit": "ms"}
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    _sync(dev)
    run.recorder.frame = None
    n_done = len(run.poses)
    failed = sum(1 for p in run.poses if not p[2])
    corrections = run.corrections - c1
    log(f"[window] frames_tracked={n_done} failed={failed} loop_corrections={corrections} "
        f"imu_initialised_before_window={imu_before} "
        f"setup_s={setup_s!r}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kf = check.keyframes(tr)
    # a tracker that returns each pose `pose_lag` calls late (pipelined)
    # returned the poses of the frames from w0 - pose_lag on
    lag = run.cell["facade"].get("pose_lag", 0)
    window = np.arange(run.w0 - lag, run.w0 - lag + n_done)
    centres = [-R.T @ t for R, t, _ in run.poses]
    from slam_bench.reference import trajectory as ref_traj
    # one input, one answer: the first 20 window poses' bytes, the same in
    # every run of a seed whatever its speed
    digest = hashlib.sha256(np.stack([np.concatenate([R.ravel(), t]) for R, t, _ in
                                      run.poses[:20]]).tobytes()).hexdigest()[:16]
    log(f"[window] whole_window_ate_m={ref_traj.horn_ate(centres, run.scene.t_wc[window])!r} "
        f"keyframes={len(kf['ts'])} first_poses_sha256={digest} (reported, not compared)")
    recorder, scn, orb = run.recorder, run.scene, run.config["orb"]
    poses = run.poses
    del run, tr
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    seg = {"frames": chk["segment_frames"], "keyframes": chk["segment_keyframes"]}
    t_ref = time.perf_counter()
    nums = check.numbers(scn, window, poses, kf, recorder, orb, seg, dev)
    log(f"[reference] seconds={time.perf_counter() - t_ref:.3f}")
    log("[numbers] " + " ".join(f"{k}={v!r}" for k, v in nums.items()))
    result = {"correct": None, "attempted": n_done, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak), **out_device}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control:
        result["program"] = nums
        result["faults"] = check.fault_numbers(scn, window, kf, seg)
        nums = check.control_numbers(scn, window, kf, recorder, orb, seg, dev)
    limits = bench.cell_file(name)["limits"]
    # a number that could not be read (a drawn frame or call the window did
    # not make, a map without the window's keyframes) is null and fails
    checks = {k: {"value": nums[k] if np.isfinite(nums[k]) else None, "limit": limits[k]}
              for k in check.NUMBERS if k in limits}
    result["correct"] = bool(all(c["value"] is not None and c["value"] <= c["limit"]
                                 for c in checks.values()) and n_done >= 2)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.Bench(Path.cwd())
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"slam_bench: needs {cell['chips']} CUDA device(s); "
            f"available={torch.cuda.is_available()} count={torch.cuda.device_count()}")
        return 2
    return emit(run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace)))


def emit(result: dict) -> int:
    """Print the run's result: each compared number beside its limit as the
    last lines of standard error, the JSON object as the last line of
    standard output. Refuses (no result, exit 3) when JAX or the JAX package
    is loaded in this process."""
    found = forbidden_modules()
    if found:
        log(f"slam_bench: JAX or the JAX package was loaded: {found}")
        return 3
    for k, c in result["checks"].items():
        log(f"[check] {k} = {c['value']!r} (limit {c['limit']!r})")
    log(f"[check] correct = {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
