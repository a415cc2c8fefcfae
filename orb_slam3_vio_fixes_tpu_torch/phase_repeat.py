"""Repeat one phase of chip_smoke.py on the card, to see its spread.

    python -m orb_slam3_vio_fixes_tpu_torch.phase_repeat app
    python -m orb_slam3_vio_fixes_tpu_torch.phase_repeat stereo_inertial [N [variant]]
    python -m orb_slam3_vio_fixes_tpu_torch.phase_repeat si_atlas [N]
    python -m orb_slam3_vio_fixes_tpu_torch.phase_repeat determinism
    python -m orb_slam3_vio_fixes_tpu_torch.phase_repeat mesh [N]

`app`: the facade's direct IMU_STEREO loop (phase 14's frames) and phase 15
(the same frames through apps.main_template and the PipelineRunner) in
turns, direct / app / app / direct / app, each app run printing its frame
median beside the last direct loop's. `stereo_inertial`: phase 7 N times
(default 3), as chip_smoke.py runs it, under a host-side trace, or with
eig_fn's former device path (SI_VARIANTS, see _stereo_inertial);
`si_atlas`: phase 13 N times (default 3), printing for every merge
verification its Sim3 gates, the tilt of the world alignment the Sim3
implies, and both maps' median gravity error against the truth. Both
print, per run, whether it passed, the gated value (phase 7's ATE, phase
13's final camera centre and its error) and a SHA-256 of the final map's
keyframe poses and the tracker's pose, then whether every run gave the
same bytes and the first frame where each run parts from run 0. `determinism`: phase 5's
and phase 7's tracking passes with PyTorch's deterministic algorithms on,
on with the fill of uninitialised memory, and off, in turns: fps, frame
p50 / p95, ATE and the digest of each. `mesh`: phase 20 (a), the loop
scene with its global BAs sharded over a 4-shard mesh of the card, N times
(default 3), each run's digest as above. Needs a CUDA device; ~30 s
per app or direct run, ~60 s per stereo_inertial run, ~70-100 s per
si_atlas run, ~8 min for determinism.

Like chip_smoke.py, it switches PyTorch to deterministic algorithms before
any CUDA work (utils/determinism.py).
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import sys
import tempfile
import time
from unittest import mock

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


def _digest(tr) -> str:
    """SHA-256 of the final map's keyframe poses and the tracker's pose."""
    h = hashlib.sha256()
    for x in (tr.state.kf_R, tr.state.kf_t, tr.R, tr.t):
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _repeat(name, n_runs, run, factory, value) -> None:
    """Run a phase n_runs times, capturing the trackers `factory` (a name in
    chip_smoke) makes; print each run's outcome, value(tracker) and digest,
    then whether all digests agree."""
    import chip_smoke as cs

    made = []
    build = getattr(cs, factory)

    def capture(*a, **k):
        made.append(build(*a, **k))
        return made[-1]

    digests = []
    with mock.patch.object(cs, factory, capture):
        for r in range(n_runs):
            t0 = time.perf_counter()
            try:
                run()
                status = "passed"
            except RuntimeError as e:
                status = f"failed ({e})"
            digests.append(_digest(made[-1]))
            print(f"[repeat] {name} run {r} {status} {value(made[-1])} "
                  f"state_sha256={digests[-1]} seconds={time.perf_counter() - t0:.1f}",
                  flush=True)
    print(f"[repeat] {name}: {n_runs} runs, bitwise identical={len(set(digests)) == 1}",
          flush=True)
    for r in range(1, n_runs):
        print(f"[repeat] {name} run {r} vs run 0: first differing frame "
              f"{_first_frame_apart(made[0].traj, made[r].traj)}", flush=True)


def _first_frame_apart(a, b):
    """Index of the first trajectory entry (stamp, reference keyframe, pose
    relative to it) that differs in any bit between two runs, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x[:2] != y[:2] or not (np.array_equal(x[2], y[2]) and np.array_equal(x[3], y[3])):
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def _leaves(x):
    """The tensors inside x (nested tuples, lists, dicts, NamedTuples)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _leaves(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _leaves(y)


def _host_digest(x, max_numel=None) -> str:
    """Digest of the bytes of the contiguous tensors in x (those of at most
    max_numel elements), copied to the host: no device allocation."""
    h = hashlib.sha256()
    for t in _leaves(x):
        if t.is_contiguous() and (max_numel is None or t.numel() <= max_numel):
            h.update(str((tuple(t.shape), t.dtype)).encode())
            h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:12]


# Port modules whose module-level functions `trace_host` wraps (calls
# between them resolve through module attributes, so nested calls are seen).
TRACED = ("frontend.tracking", "frontend.inertial_tracking", "frontend.frame",
          "frontend.local_mapping", "imu.preintegration", "optim.inertial_init",
          "optim.vi_ba", "optim.vi_global_ba", "optim.ba_core", "ops.matching",
          "ops.orb", "ops.fast")


@contextlib.contextmanager
def _tracer(log: list, on: list):
    """While on[0] is true, each call of a TRACED module's function appends
    (name, host digest of its tensor inputs of at most 20,000 elements,
    host digest of its tensor outputs) to `log`; nothing is allocated on
    the card."""
    import importlib
    import types

    saved = []

    def wrap(qual, fn):
        def traced(*a, **k):
            if not on[0]:
                return fn(*a, **k)
            d_in = _host_digest((a, k), max_numel=20000)
            out = fn(*a, **k)
            log.append((qual, d_in, _host_digest(out)))
            return out
        return traced

    for name in TRACED:
        mod = importlib.import_module(f"orb_slam3_vio_fixes_tpu_torch.{name}")
        for attr, fn in list(vars(mod).items()):
            if (isinstance(fn, types.FunctionType) and not attr.startswith("__")
                    and fn.__module__ == mod.__name__):
                saved.append((mod, attr, fn))
                setattr(mod, attr, wrap(f"{name}.{attr}", fn))
    try:
        yield log
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _first_divergence(a: list, b: list) -> str:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            lo = max(0, i - 3)
            ctx = " | ".join(f"{j}:{a[j][0]} in={a[j][1]}/{b[j][1]} "
                             f"out={a[j][2]}/{b[j][2]}" for j in range(lo, min(i + 2, len(a))))
            return f"first differing call {i} of {len(a)}/{len(b)}: {ctx}"
    return f"no differing call ({len(a)} / {len(b)} calls)"


def _device_eig_fn(M, fn):
    """optim.inertial_init.eig_fn as it was before it moved to the host
    (cuSOLVER's eigh and the batched product on M's device), on fresh
    contiguous copies of M and of eigh's outputs."""
    M = M.clone(memory_format=torch.contiguous_format)
    val, vec = torch.linalg.eigh(M)
    val = val.clone(memory_format=torch.contiguous_format)
    vec = vec.clone(memory_format=torch.contiguous_format)
    return (vec * fn(val)[..., None, :]) @ vec.transpose(-1, -2)


# `stereo_inertial` variants: what the phase runs besides the tracking.
SI_VARIANTS = ("script", "trace_host", "device_eig_clone")


def _stereo_inertial(cs, dev, card, n_runs: int, variant: str = "script") -> None:
    """Phase 7 n_runs times. `script` runs it as chip_smoke.py does;
    `trace_host` as `script`, with every call of the TRACED modules'
    functions over frames 15-22 digested on the host, printing the first
    call whose digests differ from run 0's (it found the history dependence
    that moved eig_fn to the host); `device_eig_clone` as `script` with
    eig_fn's former device path on fresh contiguous copies (it still parts
    from run 0: the bytes do not follow the inputs' storage)."""
    from orb_slam3_vio_fixes_tpu_torch.optim import inertial_init, vi_ba

    seq = cs.make_inertial_sequence()
    stack = contextlib.ExitStack()
    run = lambda: cs.inertial_path(seq, dev, card)     # noqa: E731
    if variant == "device_eig_clone":
        for mod in (inertial_init, vi_ba):
            stack.enter_context(mock.patch.object(mod, "eig_fn", _device_eig_fn))
    logs = []
    if variant == "trace_host":
        on = [False]
        track = cs.track_frame

        def track_window(tr, seq, i):
            on[0] = 15 <= i <= 22
            try:
                return track(tr, seq, i)
            finally:
                on[0] = False

        stack.enter_context(mock.patch.object(cs, "track_frame", track_window))

        def run():
            logs.append([])
            with _tracer(logs[-1], on):
                cs.inertial_path(seq, dev, card)
            if len(logs) > 1:
                print(f"[trace] run {len(logs) - 1} vs run 0: "
                      f"{_first_divergence(logs[0], logs[-1])}", flush=True)
    with stack:
        _repeat(f"stereo_inertial[{variant}]", n_runs, run, "build_inertial_tracker",
                lambda tr: f"ate_m={cs.trajectory_ate(seq.ts, seq.t_wc, tr, cs.VI_FRAMES)!r}")


def _si_atlas(cs, dev, card, n_runs: int) -> None:
    from orb_slam3_vio_fixes_tpu_torch.slam_map import atlas as atlas_mod
    from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary

    vocab = vocabulary.default_vocabulary(dev)
    verify = atlas_mod.verify_cross_candidate
    p = cs.SI_ATLAS_PLAN
    seq = cs.make_si_loop_sequence(cs.SI_ATLAS_LAP, p["frames"])

    def gravity_deg(state):
        """Median angle between each live keyframe's gravity (world -Z in
        the camera frame) and the truth's (the scene's -Y)."""
        live = state.kf_valid.cpu().numpy()
        kf_R = state.kf_R.cpu().numpy()[live].astype(np.float64)
        fi = np.rint(state.kf_ts.cpu().numpy()[live] / (seq.ts[1] - seq.ts[0])).astype(int)
        g_est = kf_R @ np.array([0.0, 0.0, -1.0])
        g_true = np.einsum("kji,j->ki", seq.R_wc[fi], np.array([0.0, -1.0, 0.0]))
        cos = np.clip((g_est * g_true).sum(-1), -1.0, 1.0)
        return float(np.median(np.degrees(np.arccos(cos))))

    def logged(*a, **k):
        n_m, n_proj, sim = verify(*a, **k)
        cur, kf, old, cand = a[1], a[2], a[3], a[4]
        # the tilt of the world alignment the full Sim3 implies
        Rw = (old.kf_R[cand].T @ sim.R.T @ cur.kf_R[kf]).cpu().numpy()
        tilt = float(np.degrees(np.arccos(np.clip(Rw[2, 2], -1.0, 1.0))))
        print(f"[merge-verify] kf={kf} cand={cand} n_m={int(n_m)} n_proj={int(n_proj)} "
              f"n_inliers={int(sim.n_inliers)} alignment_tilt_deg={tilt!r} "
              f"gravity_err_deg(active, stored)=({gravity_deg(cur)!r}, {gravity_deg(old)!r})",
              flush=True)
        return n_m, n_proj, sim

    def centre(tr):
        c = -tr.R.cpu().numpy().T @ tr.t.cpu().numpy()
        err = cs.aligned_centre_error(seq, tr, p["atlas_map"], p["frames"] - 1)
        return f"centre={c.tolist()!r} centre_err_m={err!r}"

    with mock.patch.object(atlas_mod, "verify_cross_candidate", logged):
        _repeat("si_atlas", n_runs, lambda: cs.si_atlas_path(vocab, dev, card),
                "build_si_loop_tracker", centre)


def _determinism(cs, dev, card) -> None:
    """Phases 5 and 7's tracking passes with deterministic algorithms on
    (as utils/determinism.py sets them: no fill of uninitialised memory),
    on with the fill, and off, in turns (one process, one card)."""
    import torch.utils.deterministic as tud

    from orb_slam3_vio_fixes_tpu_torch.evaluation import ate

    on, fill, off = (True, False), (True, True), (False, False)
    plans = {"stereo": (cs.make_sequence(), cs.run_pass, (on, fill, off, off, fill, on)),
             "stereo_inertial": (cs.make_inertial_sequence(), cs.run_inertial_pass,
                                 (on, fill, off, off, on))}
    for name, (seq, run, modes) in plans.items():
        for det, fill_memory in modes:
            torch.use_deterministic_algorithms(det)
            tud.fill_uninitialized_memory = fill_memory
            tr, per_frame = run(seq, dev)
            traj = tr.trajectory
            rmse, _, _ = ate.ate_rmse(seq.ts, seq.t_wc, np.array([x[0] for x in traj]),
                                      np.array([-R.T @ t for _, R, t in traj]))
            ms = 1e3 * np.asarray(per_frame[1:])
            print(f"[determinism] {card}: {name} deterministic={det} fill={fill_memory} "
                  f"fps={float(len(ms) / ms.sum() * 1e3)!r} p50_ms={float(np.median(ms))!r} "
                  f"p95_ms={float(np.percentile(ms, 95))!r} ate_m={rmse!r} "
                  f"state_sha256={_digest(tr)}", flush=True)
    torch.use_deterministic_algorithms(True)
    tud.fill_uninitialized_memory = False


def _mesh(cs, dev, card, n_runs: int) -> None:
    """Phase 20 (a), the loop scene with a LoopCloser on a 4-shard mesh of
    the card, n_runs times."""
    from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary

    vocab = vocabulary.default_vocabulary(dev)
    _repeat("mesh", n_runs, lambda: cs.mesh_loop(vocab, dev, card), "build_kf4_tracker",
            lambda tr: f"keyframes={len(tr.kf_order)} "
                       f"corrections={tr.loop_closer.n_corrections}")


TARGETS = ("app", "stereo_inertial", "si_atlas", "determinism", "mesh")


def main(argv=None) -> int:
    import chip_smoke as cs  # the scenarios, phases and checks (repository root)

    from orb_slam3_vio_fixes_tpu_torch import kernels
    from orb_slam3_vio_fixes_tpu_torch.utils import determinism

    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in TARGETS:
        raise SystemExit(__doc__)
    card = cs.card_facts()
    determinism.enable()            # before any CUDA work
    print(f"[card] {card}", flush=True)
    kernels.build()
    kernels.library()
    dev = torch.device("cuda")
    n_runs = int(argv[1]) if len(argv) > 1 else 3
    if argv[0] == "app":
        _app(cs, dev, card)
    elif argv[0] == "stereo_inertial":
        variant = argv[2] if len(argv) > 2 else "script"
        if variant not in SI_VARIANTS:
            raise SystemExit(f"variants: {', '.join(SI_VARIANTS)}")
        _stereo_inertial(cs, dev, card, n_runs, variant)
    elif argv[0] == "si_atlas":
        _si_atlas(cs, dev, card, n_runs)
    elif argv[0] == "mesh":
        _mesh(cs, dev, card, n_runs)
    else:
        _determinism(cs, dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
