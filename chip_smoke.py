"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order (any failure raises and the script exits non-zero):
  1. card facts (nvidia-smi name and power limit); no CUDA -> exit non-zero;
  2. build the hand-written kernels from orb_slam3_vio_fixes_tpu_torch/csrc;
  3. K1 (FAST score) against its plain PyTorch twin, exact, on random and
     half-integer atlases at the main path's shape, at W = 751 and at
     H = 7, W = 37, and on rendered frames' atlases;
  4. K2 (fused masked Hamming best-2 + column argmin, one launch) against its
     plain twin, exact, with and without columns: 1024x1024 and 2048x1024
     with random, dense, sparse, tie-heavy, nearly and wholly masked inputs;
     Q = T = 1, T = 1000 and 2048, Q = 300; and the two masks captured from
     the main path (frame 0's stereo row match, a local-map search);
  5. the main path: the bench scenario (80 frames of 752x480 stereo, 1024
     features, 8 levels) through the port's StereoTracker in sync mode, with
     the kernel launch counters reset before and read after; the final state
     must be OK, >= 3 keyframes, K1 launched once per frame, K2 at least
     once per matcher call that the tracker's control flow always makes (and
     once with columns per stereo and triangulation call), and the ATE
     within the stated bound of the JAX package's;
  6. timing: a second pass with a fresh tracker (fps, p50/p95 frame ms) and
     each kernel at the path's shapes: device time per call back to back
     (CUDA events) and the host's time to enqueue it, the kernel's own
     execution time (torch.profiler), bound, plain twin's time and the first
     slice's recorded time;
  7. the stereo-inertial path: bench.py's stereo-inertial scenario (60 frames
     of 752x480 stereo with 200 Hz IMU, 1024 features) through the port's
     StereoInertialTracker, the launch counters reset before and read after;
     the final state must be OK with the IMU initialised, >= 2 window VI
     BAs, the ATE within the stated bound of the JAX package's, the final
     speed within 25% of the true one, K1 launched once per frame and K2 at
     least once per matcher call the control flow always makes; K1 and K2
     are held against their plain twins once more on this path's inputs;
     that pass also prints synchronised host-clock stage times and, from
     torch.profiler over its last 10 frames, launches per frame and the
     device's idle share; then a timing pass (fps, p50/p95 frame ms).

The last lines are one JSON object with the kernels, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""

import json
import re
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

# ATE of the JAX package's StereoTracker (sync mode: pipelined=False,
# async_kf=False) on the same 80-frame bench scenario, measured once on a CPU
# with JAX 0.9.0 by running bench.make_sequence() / bench.build_tracker()
# through process_stereo and evaluation.ate.ate_rmse on the camera centres.
JAX_ATE_M = 0.003896803325557025
ATE_FACTOR = 1.5
ATE_SLACK_M = 0.005

N_FRAMES = 80

# ATE of the JAX package's StereoInertialTracker on the same 60-frame
# stereo-inertial scenario (bench.run_inertial_bench's sequence, tracker and
# configuration, one pass), measured once on a CPU with JAX 0.9.0 through
# process_stereo_inertial and evaluation.ate.ate_rmse on the camera centres.
# That run ended OK, IMU initialised at frame 15, 8 window VI BAs, final
# speed error 0.0266 m/s.
JAX_VI_ATE_M = 0.008476832977569036
VI_FRAMES = 60
VI_SPEED_TOL = 0.25         # |v_est - v_gt| < 0.25 max(v_gt, 0.2) (test bar)

# The card's peaks for the bounds: HBM3 rate of the H100 SXM, and its INT32
# rate, a quarter of the 67 TFLOP/s float32 rate (an FMA counts 2 flops, and
# an SM has 64 INT32 lanes beside 128 FP32 lanes).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# K1 per interior pixel: 46 packed min/max (22 + 16 min3, 8 max3 over the 16
# arcs and the centre) + 1 subtraction of the centre; K2 per admissible pair:
# 8 XOR + 8 POPC + 7 ADD.
K1_OPS_PER_PX = 47
K2_OPS_PER_PAIR = 23

# Device ms of the first slice's kernels (PERF.md, NVIDIA H100 80GB HBM3 at
# 700 W), at the shapes timed below.
PR1_MS = {"fast_score 2x2380x752": 0.0553,
          "hamming_match 1024x1024 cols": 0.0249 + 0.0452,
          "hamming_match 1024x1024 rows": 0.0249,
          "hamming_match 2048x1024 rows": 0.0254,
          "hamming_match 2048x1024 cols": 0.0254 + 0.0874}


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def card_facts() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int, host: bool = False):
    """Mean device milliseconds per call over `iters` back-to-back calls.
    The stream is held busy (torch.cuda._sleep) while the host enqueues
    them, so the events time the device and not the host's launch rate.
    With `host`, also the host's milliseconds per call to enqueue them."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * 4e5))      # ~0.2 ms of cycles per call
    start.record()
    h0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = 1e3 * (time.perf_counter() - h0) / iters
    end.record()
    sync()
    dev_ms = start.elapsed_time(end) / iters
    return (dev_ms, host_ms) if host else dev_ms


def profiled_ms(fn, iters: int = 20) -> dict:
    """Device ms per call of each kernel (and memset) that `fn` launches, from
    torch.profiler's kernel records: execution alone, without the gaps
    between launches that the events of cuda_ms include."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        sync()
    return {re.sub(r"^.*?_cu_[0-9a-f]{8}\d+", "", e.key)[:40]:
            e.device_time_total / 1e3 / iters
            for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0}


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least ms the card could take: bytes over HBM, int ops over INT32."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / INT32_OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def k1_bound(x) -> tuple[float, str]:
    b, h, w = x.shape
    interior = b * max(h - 6, 0) * max(w - 6, 0)
    return bound(8.0 * b * h * w, K1_OPS_PER_PX * interior)


def k2_bound(dq, dt, mask, cols) -> tuple[float, str]:
    Q, T = mask.shape
    n_bytes = Q * T + 32 * (Q + T) + 16 * Q + (8 * T if cols else 0)
    return bound(n_bytes, K2_OPS_PER_PAIR * int(mask.sum()))


def make_sequence(n_frames: int = N_FRAMES):
    """bench.make_sequence() with the port's numpy generator."""
    from orb_slam3_vio_fixes_tpu_torch.io import synthetic

    rng = np.random.default_rng(7)
    world = synthetic.make_world(rng, n_points=1400, extent=10.0,
                                 depth_range=(3.0, 14.0))
    seq = synthetic.make_stereo_sequence(rng, n_frames=n_frames, h=480, w=752,
                                         fx=458.0, baseline=0.11, world=world)
    return seq._replace(
        imgs_l=np.clip(np.rint(seq.imgs_l), 0, 255).astype(np.uint8),
        imgs_r=np.clip(np.rint(seq.imgs_r), 0, 255).astype(np.uint8))


def build_tracker(seq, device):
    """bench.build_tracker() for the port, sync mode."""
    from orb_slam3_vio_fixes_tpu_torch.frontend import tracking
    from orb_slam3_vio_fixes_tpu_torch.ops import orb
    from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms
    from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera

    cfg = tracking.TrackerConfig(
        orb=orb.ORBConfig(n_features=1024, n_levels=8),
        map=ms.MapConfig(max_keyframes=256, max_landmarks=32768,
                         max_features=1024),
        width=seq.imgs_l.shape[2], height=seq.imgs_l.shape[1],
        max_frames_between_kf=20)
    cam = Camera.pinhole(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2])
    return tracking.StereoTracker(cam, seq.K[0, 0] * seq.baseline, cfg,
                                  device=device)


def atlases_of(seq, i, device):
    from orb_slam3_vio_fixes_tpu_torch.ops import image as image_ops

    layout = image_ops.atlas_layout(480, 752, 8, 1.2, align=35)
    imgs = torch.from_numpy(np.stack([seq.imgs_l[i], seq.imgs_r[i]])).to(device)
    return image_ops.build_pyramid_atlas(imgs, 8, 1.2, layout)


def check_k1(seq, device) -> dict:
    from orb_slam3_vio_fixes_tpu_torch.ops import fast

    g = torch.Generator(device=device).manual_seed(0)

    def ints(shape, half=False):
        x = torch.randint(0, 511 if half else 256, shape, generator=g, device=device)
        return x.to(torch.float32) * (0.5 if half else 1.0)

    cases = {
        "random": ints((2, 2380, 752)),
        # half-integers exercise the round-half-to-even step
        "random_half": ints((2, 2380, 752), half=True),
        # W % 4 != 0 takes the scalar staging path; H, W below one tile
        "w751": ints((2, 2380, 751)),
        "w751_half": ints((2, 2380, 751), half=True),
        "h7_w37": ints((2, 7, 37)),
        "h7_w37_half": ints((2, 7, 37), half=True),
        "frame0": atlases_of(seq, 0, device),
        "frame_last": atlases_of(seq, seq.imgs_l.shape[0] - 1, device),
    }
    err = 0.0
    for name, x in cases.items():
        got = fast.fast_score_batch(x)
        ref = fast.fast_score_plain(x)
        sync()
        e = float((got - ref).abs().max())
        n_bad = int((got != ref).sum())
        log(f"[k1] {name}: shape={tuple(x.shape)} max_abs_err={e} mismatches={n_bad} "
            f"nonzero={int((ref > 0).sum())}")
        if n_bad:
            raise RuntimeError(f"K1 disagrees with its plain twin on {name}")
        err = max(err, e)
    return {"max_abs_err": err}


def _k2_inputs(g, Q, T, kind, device):
    def rnd(n):
        return torch.randint(-2**31, 2**31, (n, 8), generator=g, device=device,
                             dtype=torch.int64).to(torch.int32)

    if kind == "ties":
        # descriptors from a tiny pool, one differing word: distances repeat
        pool = rnd(4)
        dq = pool[torch.randint(0, 4, (Q,), generator=g, device=device)].clone()
        dt = pool[torch.randint(0, 4, (T,), generator=g, device=device)].clone()
        dq[:, 0] = torch.randint(0, 4, (Q,), generator=g, device=device).to(torch.int32)
        dt[:, 0] = torch.randint(0, 4, (T,), generator=g, device=device).to(torch.int32)
    else:
        dq, dt = rnd(Q), rnd(T)
    density = {"dense": 1.0, "random": 0.3, "sparse": 0.002, "ties": 0.5,
               "empty_rows": 0.0005, "none": 0.0}[kind]
    mask = torch.rand((Q, T), generator=g, device=device) < density
    return dq, dt, mask


def _k2_compare(label, dq, dt, mask) -> int:
    """Fused kernel vs plain twin, with and without columns; max abs error."""
    from orb_slam3_vio_fixes_tpu_torch.ops import matching

    names = ("best_idx", "best", "second", "second_idx", "col_idx")
    err = 0
    for cols in (False, True):
        got = matching.hamming_match(dq, dt, mask, cols)
        ref = matching.match_plain(dq, dt, mask, cols)
        sync()
        if not cols and got[4] is not None:
            raise RuntimeError("K2 returned columns it was not asked for")
        pairs = [(n, a, b) for n, a, b in zip(names, got, ref) if b is not None]
        bad = [n for n, a, b in pairs if not torch.equal(a, b)]
        ties = int((ref[1] == ref[2]).sum())
        log(f"[k2] {label} cols={cols}: mismatching={bad} rows_with_tie={ties}")
        if bad:
            raise RuntimeError(f"K2 disagrees with its plain twin on {label}: {bad}")
        err = max(err, max(int((a - b).abs().max()) for _, a, b in pairs))
    return err


def check_k2(device, path_masks) -> dict:
    g = torch.Generator(device=device).manual_seed(1)
    err = 0
    shapes = [((Q, 1024), kind) for Q in (1024, 2048)
              for kind in ("random", "dense", "sparse", "ties", "empty_rows", "none")]
    shapes += [((1, 1), "dense"), ((1024, 1000), "random"), ((1024, 2048), "random"),
               ((1024, 2048), "ties"), ((300, 1024), "random"), ((300, 1000), "ties")]
    for (Q, T), kind in shapes:
        err = max(err, _k2_compare(f"{Q}x{T} {kind}", *_k2_inputs(g, Q, T, kind, device)))
    for name, (dq, dt, mask, _) in path_masks.items():
        err = max(err, _k2_compare(f"path {name} {tuple(mask.shape)}", dq, dt, mask))
    return {"max_abs_err": float(err)}


def matcher_recorder(wanted):
    """(record, tagged, out): `record` stands in for matching.hamming_match
    and keeps the inputs of the first call made under each wanted caller
    path in `out`; `tagged(key, fn)` wraps fn so that the calls it makes
    are under key ("outer/inner" when nested)."""
    from orb_slam3_vio_fixes_tpu_torch.ops import matching

    out, tags = {}, []
    match = matching.hamming_match

    def record(desc_q, desc_t, mask, cols):
        key = "/".join(tags)
        if key in wanted and key not in out:
            out[key] = (desc_q.clone(), desc_t.clone(), mask.clone(), cols)
        return match(desc_q, desc_t, mask, cols)

    def tagged(key, fn):
        def call(*args, **kw):
            tags.append(key)
            try:
                return fn(*args, **kw)
            finally:
                tags.pop()
        return call

    return record, tagged, out


def capture_path_masks(seq, device) -> dict:
    """Frame 0's stereo row-match mask and the first local-map search mask of
    a fresh tracker's first frames: the masks the main path gives K2."""
    from orb_slam3_vio_fixes_tpu_torch.frontend import tracking
    from orb_slam3_vio_fixes_tpu_torch.ops import matching

    record, tagged, out = matcher_recorder({"stereo_frame0", "local_map_search"})
    tr = build_tracker(seq, device)
    with mock.patch.object(matching, "hamming_match", record), \
            mock.patch.object(matching, "stereo_row_match",
                              tagged("stereo_frame0", matching.stereo_row_match)), \
            mock.patch.object(tracking, "local_map_search",
                              tagged("local_map_search", tracking.local_map_search)):
        for i in range(3):
            tr.process_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
    sync()
    for key in ("stereo_frame0", "local_map_search"):
        if key not in out:
            raise RuntimeError(f"no {key} matcher call in the first frames")
        _, _, mask, cols = out[key]
        log(f"[k2] path mask {key}: shape={tuple(mask.shape)} cols={cols} "
            f"density={float(mask.float().mean())!r} admissible={int(mask.sum())}")
    return out


def make_inertial_sequence(n_frames: int = VI_FRAMES):
    """bench.run_inertial_bench's sequence with the port's numpy generator."""
    from orb_slam3_vio_fixes_tpu_torch.io import synthetic

    rng = np.random.default_rng(11)
    world = synthetic.make_world(rng, n_points=1400, extent=10.0,
                                 depth_range=(3.0, 14.0))
    seq = synthetic.make_stereo_inertial_sequence(
        rng, n_frames=n_frames, h=480, w=752, fx=458.0, baseline=0.11, world=world,
        imu_hz=200.0, accel_amp=0.6)
    return seq._replace(
        imgs_l=np.clip(np.rint(seq.imgs_l), 0, 255).astype(np.uint8),
        imgs_r=np.clip(np.rint(seq.imgs_r), 0, 255).astype(np.uint8))


def build_inertial_tracker(seq, device):
    """bench.run_inertial_bench's tracker for the port, sync mode."""
    from orb_slam3_vio_fixes_tpu_torch.frontend import inertial_tracking as it
    from orb_slam3_vio_fixes_tpu_torch.imu import preintegration as pre

    base = build_tracker(seq, device)
    icfg = it.InertialConfig(frame_samples=16, kf_samples=256, init_min_kfs=4,
                             init_min_time=0.5, vi_window=6, fix_scale=True)
    calib = pre.ImuCalib.make(1.7e-4, 2e-3, 1.9e-5, 3e-3, seq.imu_hz, device=device)
    return it.StereoInertialTracker(base.cam, seq.K[0, 0] * seq.baseline, calib,
                                    base.cfg, icfg, device=device)


def track_frame(tr, seq, i):
    """One frame through the tracker's entry point (stereo or stereo-inertial,
    by the sequence)."""
    if hasattr(seq, "imu"):
        imu = seq.imu[i - 1] if i > 0 else np.zeros((0, 7), np.float32)
        return tr.process_stereo_inertial(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i], imu)
    return tr.process_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])


def run_pass(seq, device, build=build_tracker):
    tr = build(seq, device)
    per_frame = []
    for i in range(seq.imgs_l.shape[0]):
        f0 = time.perf_counter()
        track_frame(tr, seq, i)
        sync()
        per_frame.append(time.perf_counter() - f0)
    return tr, per_frame


def run_inertial_pass(seq, device):
    return run_pass(seq, device, build=build_inertial_tracker)


def main_path(seq, device) -> dict:
    from orb_slam3_vio_fixes_tpu_torch import kernels
    from orb_slam3_vio_fixes_tpu_torch.evaluation import ate
    from orb_slam3_vio_fixes_tpu_torch.frontend.tracking import TrackState

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tr, _ = run_pass(seq, device)
    sync()
    counts = kernels.launch_counts()
    wall = time.perf_counter() - t0
    # Matcher calls the control flow always makes: a stereo match per frame
    # (with columns), a motion-model and a local-map search per tracked
    # frame, and per inserted keyframe a triangulation (with columns) and a
    # fusion for each of 3 neighbour slots. Retries and the reference-KF
    # fallback add more.
    n_ins = tr._kf_seq
    min_calls = N_FRAMES + 2 * (N_FRAMES - 1) + 6 * n_ins
    min_cols = N_FRAMES + 3 * n_ins
    traj = tr.trajectory
    est_ts = np.array([x[0] for x in traj])
    est_pos = np.array([-x[1].T @ x[2] for x in traj])
    if not np.all(np.isfinite(est_pos)) or est_pos.shape != (N_FRAMES, 3):
        raise RuntimeError(f"bad trajectory: shape {est_pos.shape}")
    rmse, _, n = ate.ate_rmse(seq.ts, seq.t_wc, est_ts, est_pos)
    ate_bound = ATE_FACTOR * JAX_ATE_M + ATE_SLACK_M
    log(f"[main] frames={N_FRAMES} wall={wall:.1f}s state={tr.track_state} "
        f"keyframes={len(tr.kf_order)} n_kf={tr.n_kf} landmarks={tr.n_lm} "
        f"ate_rmse_m={rmse!r} bound_m={ate_bound!r} (jax {JAX_ATE_M!r}) "
        f"launches={counts} keyframe_inserts={n_ins} "
        f"min_matcher_calls={min_calls} min_matcher_calls_with_cols={min_cols}")
    if tr.track_state != TrackState.OK:
        raise RuntimeError(f"final track state {tr.track_state}")
    if len(tr.kf_order) < 3:
        raise RuntimeError(f"only {len(tr.kf_order)} keyframes")
    if n != N_FRAMES or not rmse <= ate_bound:
        raise RuntimeError(f"ATE {rmse} m over the bound {ate_bound} m (n={n})")
    if counts["fast_score"] != N_FRAMES:
        raise RuntimeError(f"K1 launched {counts['fast_score']} times for "
                           f"{N_FRAMES} frames")
    if (counts["hamming_match"] < min_calls
            or counts["hamming_match_cols"] < min_cols):
        raise RuntimeError(f"K2 launched {counts['hamming_match']} times "
                           f"({counts['hamming_match_cols']} with columns) for at "
                           f"least {min_calls} matcher calls ({min_cols} with columns)")
    return counts


def inertial_path(seq, device, card) -> dict:
    """The stereo-inertial path once, counted, with the matcher's inputs of
    the post-init motion-model and local-map searches recorded, synchronised
    host-clock stage times and torch.profiler over the last 10 frames
    (launches per frame; `profile_track.py --inertial` gives them per
    stage); checks its outcome and holds K1 and K2 against their plain
    twins on this path's inputs. Returns the launch counts."""
    import functools

    from orb_slam3_vio_fixes_tpu_torch import kernels
    from orb_slam3_vio_fixes_tpu_torch import profile_track as pt
    from orb_slam3_vio_fixes_tpu_torch.evaluation import ate
    from orb_slam3_vio_fixes_tpu_torch.frontend import inertial_tracking as it
    from orb_slam3_vio_fixes_tpu_torch.frontend import tracking
    from orb_slam3_vio_fixes_tpu_torch.frontend.tracking import TrackState
    from orb_slam3_vio_fixes_tpu_torch.ops import fast, matching

    vi_keys = ("vi_track_step/match_previous", "vi_track_step/local_map_search")
    record, tagged, masks = matcher_recorder(set(vi_keys))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(matching, "hamming_match", record), \
            mock.patch.object(it, "vi_track_step", tagged("vi_track_step", it.vi_track_step)), \
            mock.patch.object(tracking, "match_previous",
                              tagged("match_previous", tracking.match_previous)), \
            mock.patch.object(tracking, "local_map_search",
                              tagged("local_map_search", tracking.local_map_search)), \
            pt.stage_timers(pt.INERTIAL_STAGES) as times:
        tr = build_inertial_tracker(seq, device)
        step = functools.partial(track_frame, tr, seq)
        start = VI_FRAMES - 10
        for i in range(start):
            step(i)
        pt.device_profile(step, range(start, VI_FRAMES), top=8, by_stage=False,
                          prefix=f"[profile] {card}: stereo-inertial frames "
                          f"{start}-{VI_FRAMES - 1}, stages synchronised")
    sync()
    counts = kernels.launch_counts()
    wall = time.perf_counter() - t0
    pt.print_stages(times, prefix=f"[stages] {card}: stereo-inertial")
    n_ins = tr._kf_seq
    min_calls = VI_FRAMES + 2 * (VI_FRAMES - 1) + 6 * n_ins
    min_cols = VI_FRAMES + 3 * n_ins
    traj = tr.trajectory
    est_ts = np.array([x[0] for x in traj])
    est_pos = np.array([-x[1].T @ x[2] for x in traj])
    if not np.all(np.isfinite(est_pos)) or est_pos.shape != (VI_FRAMES, 3):
        raise RuntimeError(f"bad stereo-inertial trajectory: shape {est_pos.shape}")
    rmse, _, n = ate.ate_rmse(seq.ts, seq.t_wc, est_ts, est_pos)
    ate_bound = ATE_FACTOR * JAX_VI_ATE_M + ATE_SLACK_M
    v_est = float(np.linalg.norm(tr.velocity_log[-1])) if tr.velocity_log else float("nan")
    v_gt = float(np.linalg.norm(seq.vel_gt[-1]))
    v_tol = VI_SPEED_TOL * max(v_gt, 0.2)
    log(f"[inertial] frames={VI_FRAMES} wall={wall:.1f}s state={tr.track_state} "
        f"imu_ready={tr.imu_ready} n_vi_ba={tr.n_vi_ba} keyframes={len(tr.kf_order)} "
        f"keyframe_inserts={n_ins} landmarks={tr.n_lm} ate_rmse_m={rmse!r} "
        f"bound_m={ate_bound!r} (jax {JAX_VI_ATE_M!r}) speed_est={v_est!r} "
        f"speed_gt={v_gt!r} speed_tol={v_tol!r} launches={counts} "
        f"min_matcher_calls={min_calls} min_matcher_calls_with_cols={min_cols}")
    if tr.track_state != TrackState.OK:
        raise RuntimeError(f"stereo-inertial final track state {tr.track_state}")
    if not tr.imu_ready or tr.n_vi_ba < 2:
        raise RuntimeError(f"imu_ready={tr.imu_ready} n_vi_ba={tr.n_vi_ba}")
    if n != VI_FRAMES or not rmse <= ate_bound:
        raise RuntimeError(f"stereo-inertial ATE {rmse} m over the bound {ate_bound} m")
    if not abs(v_est - v_gt) < v_tol:
        raise RuntimeError(f"final speed {v_est} m/s vs {v_gt} m/s (tolerance {v_tol})")
    if counts["fast_score"] != VI_FRAMES:
        raise RuntimeError(f"K1 launched {counts['fast_score']} times for "
                           f"{VI_FRAMES} stereo-inertial frames")
    if (counts["hamming_match"] < min_calls
            or counts["hamming_match_cols"] < min_cols):
        raise RuntimeError(f"K2 launched {counts['hamming_match']} times "
                           f"({counts['hamming_match_cols']} with columns) for at "
                           f"least {min_calls} matcher calls ({min_cols} with columns)")
    for i in (0, VI_FRAMES - 1):
        x = atlases_of(seq, i, device)
        got, ref = fast.fast_score_batch(x), fast.fast_score_plain(x)
        sync()
        n_bad = int((got != ref).sum())
        log(f"[k1] stereo-inertial frame {i}: mismatches={n_bad}")
        if n_bad:
            raise RuntimeError(f"K1 disagrees with its plain twin on frame {i}")
    for key in vi_keys:
        if key not in masks:
            raise RuntimeError(f"no {key} matcher call on the stereo-inertial path")
        dq, dt, mask, _ = masks[key]
        log(f"[k2] stereo-inertial path mask {key}: shape={tuple(mask.shape)} "
            f"density={float(mask.float().mean())!r}")
        _k2_compare(f"stereo-inertial {key}", dq, dt, mask)
    return counts


def inertial_timing(seq, device, card) -> None:
    """fps and frame ms of a fresh stereo-inertial pass (and its ATE, which
    the device's unordered float sums move from run to run)."""
    from orb_slam3_vio_fixes_tpu_torch.evaluation import ate

    tr, per_frame = run_inertial_pass(seq, device)
    ms_arr = 1e3 * np.asarray(per_frame[1:])
    traj = tr.trajectory
    rmse = ate.ate_rmse(seq.ts, seq.t_wc, np.array([x[0] for x in traj]),
                        np.array([-x[1].T @ x[2] for x in traj]))[0]
    log(f"[timing] {card}: stereo-inertial fps={len(ms_arr) / (ms_arr.sum() / 1e3):.3f} "
        f"frame_ms p50={np.percentile(ms_arr, 50):.2f} "
        f"p95={np.percentile(ms_arr, 95):.2f} max={ms_arr.max():.2f} "
        f"(first frame {1e3 * per_frame[0]:.1f} ms excluded) ate_rmse_m={rmse!r}")


def path_kernel_times(seq, device, path_masks, card) -> dict:
    """Each kernel at shapes the main path gives it: device ms, bound, plain
    twin's ms and the first slice's ms. Returns the JSON rows' numbers."""
    from orb_slam3_vio_fixes_tpu_torch.ops import fast, matching

    rows = {}
    x = atlases_of(seq, 0, device)
    rows["fast_score 2x2380x752"] = (
        *cuda_ms(lambda: fast.fast_score_batch(x), 50, host=True),
        cuda_ms(lambda: fast.fast_score_plain(x), 10), *k1_bound(x))
    g = torch.Generator(device=device).manual_seed(2)
    cases = [(f"hamming_match {Q}x1024 {'cols' if cols else 'rows'}",
              *_k2_inputs(g, Q, 1024, "random", device), cols)
             for Q in (1024, 2048) for cols in (True, False)]
    cases += [(f"hamming_match path {name} {'cols' if cols else 'rows'}", dq, dt, mask, cols)
              for name, (dq, dt, mask, cols) in path_masks.items()]
    for label, dq, dt, mask, cols in cases:
        rows[label] = (
            *cuda_ms(lambda: matching.hamming_match(dq, dt, mask, cols), 50, host=True),
            cuda_ms(lambda: matching.match_plain(dq, dt, mask, cols), 10),
            *k2_bound(dq, dt, mask, cols))
    for label, dq, dt, mask, cols in cases:
        log(f"[profile] {card}: {label} device ms per call by kernel: "
            f"{profiled_ms(lambda: matching.hamming_match(dq, dt, mask, cols))}")
    log(f"[profile] {card}: fast_score 2x2380x752 device ms per call by kernel: "
        f"{profiled_ms(lambda: fast.fast_score_batch(x))}")
    for label, (k_ms, h_ms, p_ms, b_ms, b_by) in rows.items():
        pr1 = PR1_MS.get(label)
        log(f"[timing] {card}: {label} kernel_ms={k_ms!r} host_enqueue_ms={h_ms!r} "
            f"bound_ms={b_ms!r} ({b_by}) "
            f"plain_ms={p_ms!r} pr1_ms={pr1!r}"
            + ("" if pr1 is None else f" below_pr1={k_ms < pr1}"))
    return rows


def main() -> int:
    card = card_facts()
    device = torch.device("cuda")
    log(f"[card] {card}")

    from orb_slam3_vio_fixes_tpu_torch import kernels

    t0 = time.perf_counter()
    so, nvcc_s = kernels.build()
    kernels.library()
    sync()
    log(f"[build] {so.name} nvcc_seconds={nvcc_s:.2f} total={time.perf_counter() - t0:.2f}s")

    seq = make_sequence()
    k1 = check_k1(seq, device)
    sync()
    path_masks = capture_path_masks(seq, device)
    k2 = check_k2(device, path_masks)
    sync()
    log(f"[k1] {k1}  [k2] {k2}")

    counts = main_path(seq, device)
    sync()

    _, per_frame = run_pass(seq, device)
    sync()
    ms_arr = 1e3 * np.asarray(per_frame[1:])
    fps = len(ms_arr) / (ms_arr.sum() / 1e3)
    log(f"[timing] {card}: fps={fps:.3f} frame_ms p50={np.percentile(ms_arr, 50):.2f} "
        f"p95={np.percentile(ms_arr, 95):.2f} max={ms_arr.max():.2f} "
        f"(first frame {1e3 * per_frame[0]:.1f} ms excluded)")
    times = path_kernel_times(seq, device, path_masks, card)
    sync()

    vi_seq = make_inertial_sequence()
    vi_counts = inertial_path(vi_seq, device, card)
    sync()
    inertial_timing(vi_seq, device, card)
    sync()

    def numbers(label):
        k_ms, _, p_ms, b_ms, b_by = times[label]
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None}

    src = "orb_slam3_vio_fixes_tpu_torch/csrc/"
    report = {"kernels": [
        {"name": "fast_score", "route": "cuda", "source": src + "fast_score.cu",
         "replaces": "orb_slam3_vio_fixes_tpu/ops/pallas_kernels.py:63",
         "launches": counts["fast_score"], **k1,
         "launches_by_path": {"stereo": counts["fast_score"],
                              "stereo_inertial": vi_counts["fast_score"]},
         **numbers("fast_score 2x2380x752")},
        {"name": "hamming_match", "route": "cuda", "source": src + "hamming.cu",
         "replaces": "orb_slam3_vio_fixes_tpu/ops/matching.py:39",
         "launches": counts["hamming_match"], **k2,
         "launches_by_path": {"stereo": counts["hamming_match"],
                              "stereo_inertial": vi_counts["hamming_match"]},
         **numbers("hamming_match 1024x1024 cols")},
    ]}
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
