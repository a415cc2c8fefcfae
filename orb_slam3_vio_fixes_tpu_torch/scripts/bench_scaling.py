"""Scaling benchmark of the landmark-sharded global BA (the port's twin of
scripts/bench_scaling.py): seconds per full `distributed_bundle_adjust`
solve of a synthetic full-map problem at 1, 2, 4 and 8 shards.

    python -m orb_slam3_vio_fixes_tpu_torch.scripts.bench_scaling [--cpu]

The problem is the "full-map GBA after a long session": 256 keyframes x
1,024 observations = 262,144 reprojection factors over 65,536 landmarks,
solved by `LMConfig(n_rounds=2, n_iters=8, solver="cg", cg_iters=40)`. It
prints one JSON line per shard count and a summary line with the speedups
T(1) / T(n); SCALING_OUT names a file for the summary.

What the numbers mean here: the port's mesh runs every shard from one
process, the shards taking turns at each collective (parallel/mesh.py),
and all of them sit on the one device (the card, or the host with --cpu).
T(n) therefore measures what the sharded formulation costs over one shard
on the same silicon: the turn-taking at every psum, the per-shard launches
and every shard padded to the largest shard's factor count. It is not a
scaling between cards, whose ceiling would be n; here the ceiling is 1,
and the summary's `speedup_vs_core_ceiling` divides by the count of
distinct devices in the mesh (1).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from orb_slam3_vio_fixes_tpu_torch.optim import ba_core
from orb_slam3_vio_fixes_tpu_torch.parallel import Mesh, sharded_ba
from orb_slam3_vio_fixes_tpu_torch.scripts import device_for
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera

PROBLEM = dict(n_kf=256, n_lm=65536, obs_per_kf=1024)
CONFIG = ba_core.LMConfig(n_rounds=2, n_iters=8, solver="cg", cg_iters=40)
COUNTS = (1, 2, 4, 8)
REPS = 3


def make_problem(n_kf=96, n_lm=24576, obs_per_kf=512, seed=0, device="cuda"):
    """The reference script's problem from the same numpy draws in the same
    order (one seed, the same arrays), as a BAProblem on `device` with pose
    0 fixed: landmarks in a slab 4-16 m ahead, keyframes along x, each
    observing `obs_per_kf` random landmarks with 0.5 px of noise."""
    rng = np.random.default_rng(seed)
    cam = Camera.pinhole(458.0, 458.0, 376.0, 240.0)
    bf = float(np.float32(45.8))
    lm = rng.uniform(-8, 8, (n_lm, 3)).astype(np.float32)
    lm[:, 2] = rng.uniform(4, 16, n_lm)
    kf_t = np.zeros((n_kf, 3), np.float32)
    kf_t[:, 0] = np.linspace(0, 8, n_kf)
    kf_R = np.tile(np.eye(3, dtype=np.float32), (n_kf, 1, 1))
    pose_idx = np.repeat(np.arange(n_kf, dtype=np.int32), obs_per_kf)
    lm_idx = rng.integers(0, n_lm, n_kf * obs_per_kf).astype(np.int32)
    X = lm[lm_idx]
    Xc = X + kf_t[pose_idx] * np.array([-1.0, 0, 0])
    uv = np.stack([458.0 * Xc[:, 0] / Xc[:, 2] + 376.0,
                   458.0 * Xc[:, 1] / Xc[:, 2] + 240.0], 1)
    ur = uv[:, 0] - 45.8 / Xc[:, 2]
    uvr = np.concatenate([uv, ur[:, None]], 1).astype(np.float32)
    uvr += rng.normal(0, 0.5, uvr.shape).astype(np.float32)
    valid = Xc[:, 2] > 0.5

    def dev(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    factors = ba_core.ReprojFactors(
        dev(pose_idx, torch.int64), dev(lm_idx, torch.int64), dev(uvr),
        torch.ones(len(pose_idx), device=device), dev(valid))
    pose_fixed = torch.zeros(n_kf, dtype=torch.bool, device=device)
    pose_fixed[0] = True
    return ba_core.BAProblem(
        R=dev(kf_R), t=dev(kf_t), pose_fixed=pose_fixed, lm=dev(lm),
        lm_valid=torch.ones(n_lm, dtype=torch.bool, device=device),
        lm_fixed=torch.zeros(n_lm, dtype=torch.bool, device=device),
        factors=factors, cam=cam, bf=bf)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_n(problem, n, cfg, reps=REPS, outs=None, warmup=contextlib.nullcontext):
    """Mean seconds per solve of `problem` partitioned over n shards of its
    device: one warm-up solve (inside `warmup()`), then `reps` timed ones,
    the device synchronised before each clock read. With `outs` (a list),
    each timed solve's (R, t, lm, inlier) is appended to it."""
    device = problem.lm.device
    mesh = Mesh([device] * n, ("lm",))
    part = sharded_ba.partition_problem(problem, n)
    with warmup():
        sharded_ba.distributed_bundle_adjust(part, mesh, cfg, "lm")
        _sync(device)
    total = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        out, inlier, _ = sharded_ba.distributed_bundle_adjust(part, mesh, cfg, "lm")
        _sync(device)
        total += time.perf_counter() - t0
        if outs is not None:
            outs.append((out.R, out.t, out.lm, inlier))
    return total / reps


def shard_factor_counts(problem, n) -> np.ndarray:
    """Factors per shard of the landmark-block partition (every shard is
    padded to the largest of these)."""
    block = -(-int(problem.lm.shape[0]) // n)
    return np.bincount(problem.factors.lm_idx.cpu().numpy() // block, minlength=n)


def summary_of(times: dict, device: torch.device) -> dict:
    """The summary line of the reference script from {shard count:
    seconds per solve}."""
    counts = sorted(times)
    base = times[counts[0]]
    best = max(base / times[n] for n in counts)
    return {
        "metric": "gba_scaling_efficiency",
        "devices": counts[-1],
        "value": round(base / times[counts[-1]] / counts[-1], 3),
        "unit": "fraction",
        "n_devices_visible": torch.cuda.device_count() if device.type == "cuda" else 1,
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "host_physical_cores": os.cpu_count() or 1,
        # every shard sits on the one device: the ceiling is one device's
        "speedup_vs_core_ceiling": round(best, 3),
        "speedups": {str(n): round(base / times[n], 3) for n in counts},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the host, not the card")
    args = ap.parse_args(argv)
    device = torch.device(device_for(args.cpu))
    problem = make_problem(**PROBLEM, device=device)
    times = {}
    for n in COUNTS:
        times[n] = bench_n(problem, n, CONFIG, REPS)
        print(json.dumps({
            "metric": "distributed_gba_solve_s", "devices": n,
            "value": round(times[n], 4), "unit": "s"}), flush=True)
    summary = summary_of(times, device)
    print(json.dumps(summary))
    out = os.environ.get("SCALING_OUT")
    if out:
        with open(out, "w") as fh:
            json.dump(summary, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
