"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order (any failure raises and the script exits non-zero):
  1. card facts (nvidia-smi name and power limit); no CUDA -> exit non-zero;
  2. build the hand-written kernels from orb_slam3_vio_fixes_tpu_torch/csrc;
  3. K1 (FAST score) against its plain PyTorch twin, exact, on random atlases
     and on a rendered frame's atlases at the main path's shape;
  4. K2 (masked Hamming best-2, row and column passes) against its plain
     twin, exact, at 1024x1024 and 2048x1024 with random, dense, sparse and
     tie-heavy inputs;
  5. the main path: the bench scenario (80 frames of 752x480 stereo, 1024
     features, 8 levels) through the port's StereoTracker in sync mode, with
     the kernel launch counters reset before and read after; the final state
     must be OK, >= 3 keyframes, K1 launched once per frame, K2 launched, and
     the ATE within the stated bound of the JAX package's;
  6. timing: a second pass with a fresh tracker (fps, p50/p95 frame ms) and
     each kernel against its plain twin at the path's shapes.

The last lines are one JSON object with the kernels, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

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


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call over `iters` calls after a warm-up."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


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
    cases = {
        "random": torch.randint(0, 256, (2, 2380, 752), generator=g,
                                device=device).to(torch.float32),
        # half-integers exercise the round-half-to-even step
        "random_half": torch.randint(0, 511, (2, 2380, 752), generator=g,
                                     device=device).to(torch.float32) * 0.5,
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
    x = cases["frame0"]
    return {"max_abs_err": err,
            "ms": cuda_ms(lambda: fast.fast_score_batch(x), 50),
            "plain_ms": cuda_ms(lambda: fast.fast_score_plain(x), 10)}


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
               "empty_rows": 0.0005}[kind]
    mask = torch.rand((Q, T), generator=g, device=device) < density
    return dq, dt, mask


def check_k2(device) -> tuple[dict, dict]:
    from orb_slam3_vio_fixes_tpu_torch.ops import matching

    g = torch.Generator(device=device).manual_seed(1)
    err_r = err_c = 0
    for Q, T in ((1024, 1024), (2048, 1024)):
        for kind in ("random", "dense", "sparse", "ties", "empty_rows"):
            dq, dt, mask = _k2_inputs(g, Q, T, kind, device)
            got = matching.hamming_best2(dq, dt, mask)
            ref = matching.best2_plain(dq, dt, mask)
            gc = matching.hamming_argmin_cols(dq, dt, mask)
            rc = matching.col_argmin_plain(dq, dt, mask)
            sync()
            bad = [name for name, a, b in zip(
                ("best_idx", "best", "second", "second_idx"), got, ref)
                if not torch.equal(a, b)]
            if not torch.equal(gc, rc):
                bad.append("col_idx")
            ties = int((ref[1] == ref[2]).sum())
            log(f"[k2] {Q}x{T} {kind}: mismatching={bad} rows_with_tie={ties}")
            if bad:
                raise RuntimeError(f"K2 disagrees with its plain twin: {bad}")
            err_r = max(err_r, max(int((a - b).abs().max()) for a, b in zip(got, ref)))
            err_c = max(err_c, int((gc - rc).abs().max()))
    dq, dt, mask = _k2_inputs(g, 2048, 1024, "random", device)
    row = {"max_abs_err": float(err_r),
           "ms": cuda_ms(lambda: matching.hamming_best2(dq, dt, mask), 50),
           "plain_ms": cuda_ms(lambda: matching.best2_plain(dq, dt, mask), 10)}
    col = {"max_abs_err": float(err_c),
           "ms": cuda_ms(lambda: matching.hamming_argmin_cols(dq, dt, mask), 50),
           "plain_ms": cuda_ms(lambda: matching.col_argmin_plain(dq, dt, mask), 10)}
    return row, col


def run_pass(seq, device):
    tr = build_tracker(seq, device)
    per_frame = []
    for i in range(seq.imgs_l.shape[0]):
        f0 = time.perf_counter()
        tr.process_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
        sync()
        per_frame.append(time.perf_counter() - f0)
    return tr, per_frame


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
    traj = tr.trajectory
    est_ts = np.array([x[0] for x in traj])
    est_pos = np.array([-x[1].T @ x[2] for x in traj])
    if not np.all(np.isfinite(est_pos)) or est_pos.shape != (N_FRAMES, 3):
        raise RuntimeError(f"bad trajectory: shape {est_pos.shape}")
    rmse, _, n = ate.ate_rmse(seq.ts, seq.t_wc, est_ts, est_pos)
    bound = ATE_FACTOR * JAX_ATE_M + ATE_SLACK_M
    log(f"[main] frames={N_FRAMES} wall={wall:.1f}s state={tr.track_state} "
        f"keyframes={len(tr.kf_order)} n_kf={tr.n_kf} landmarks={tr.n_lm} "
        f"ate_rmse_m={rmse!r} bound_m={bound!r} (jax {JAX_ATE_M!r}) "
        f"launches={counts}")
    if tr.track_state != TrackState.OK:
        raise RuntimeError(f"final track state {tr.track_state}")
    if len(tr.kf_order) < 3:
        raise RuntimeError(f"only {len(tr.kf_order)} keyframes")
    if n != N_FRAMES or not rmse <= bound:
        raise RuntimeError(f"ATE {rmse} m over the bound {bound} m (n={n})")
    if counts["fast_score"] != N_FRAMES:
        raise RuntimeError(f"K1 launched {counts['fast_score']} times for "
                           f"{N_FRAMES} frames")
    if counts["hamming_best2"] <= 0 or counts["hamming_argmin_cols"] <= 0:
        raise RuntimeError(f"K2 not launched on the main path: {counts}")
    return counts


def path_kernel_times(seq, device) -> dict:
    """Each kernel against its plain twin at shapes the main path gives it:
    the frame's atlas pair for K1, a stereo row match (1024x1024) and a
    local-map search (2048x1024) for K2."""
    from orb_slam3_vio_fixes_tpu_torch.ops import matching

    g = torch.Generator(device=device).manual_seed(2)
    out = {}
    for Q in (1024, 2048):
        dq, dt, mask = _k2_inputs(g, Q, 1024, "random", device)
        out[f"best2_{Q}x1024"] = (
            cuda_ms(lambda: matching.hamming_best2(dq, dt, mask), 50),
            cuda_ms(lambda: matching.best2_plain(dq, dt, mask), 10))
        out[f"cols_{Q}x1024"] = (
            cuda_ms(lambda: matching.hamming_argmin_cols(dq, dt, mask), 50),
            cuda_ms(lambda: matching.col_argmin_plain(dq, dt, mask), 10))
    return out


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
    k2_row, k2_col = check_k2(device)
    sync()
    log(f"[k1] {k1}  [k2 rows] {k2_row}  [k2 cols] {k2_col}")

    counts = main_path(seq, device)
    sync()

    _, per_frame = run_pass(seq, device)
    sync()
    ms_arr = 1e3 * np.asarray(per_frame[1:])
    fps = len(ms_arr) / (ms_arr.sum() / 1e3)
    times = path_kernel_times(seq, device)
    log(f"[timing] {card}: fps={fps:.3f} frame_ms p50={np.percentile(ms_arr, 50):.2f} "
        f"p95={np.percentile(ms_arr, 95):.2f} max={ms_arr.max():.2f} "
        f"(first frame {1e3 * per_frame[0]:.1f} ms excluded)")
    for name, (k_ms, p_ms) in times.items():
        log(f"[timing] {card}: {name} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}")
    sync()

    src = "orb_slam3_vio_fixes_tpu_torch/csrc/"
    report = {"kernels": [
        {"name": "fast_score", "route": "cuda", "source": src + "fast_score.cu",
         "replaces": "orb_slam3_vio_fixes_tpu/ops/pallas_kernels.py:63",
         "launches": counts["fast_score"], **k1},
        {"name": "hamming_best2", "route": "cuda", "source": src + "hamming.cu",
         "replaces": "orb_slam3_vio_fixes_tpu/ops/matching.py:39",
         "launches": counts["hamming_best2"], **k2_row},
        {"name": "hamming_argmin_cols", "route": "cuda", "source": src + "hamming.cu",
         "replaces": "orb_slam3_vio_fixes_tpu/ops/matching.py:54",
         "launches": counts["hamming_argmin_cols"], **k2_col},
    ]}
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
