"""A cell traced by the program's own spans and counters
(orb_slam3_vio_fixes_tpu_torch's `runtime/tracing.py`), outside the
benchmark's window.

    python -m slam_bench.program --workload <cell> --seed <n> [--frames 80] \
        [--gap-frames 2] [--cost-window 0]

Builds the cell's facade and warms it up under one tracer, and prints the
set-up's spans. Then the program stretch: `--frames` frames with a tracer
installed that counts stream syncs by span, and nothing else around the
program (no outside wrap, no profiler). It prints the `[program]` table
(every span's calls, mean and self ms and syncs, every counter) and the
`[program] layers` rows (`layers`), all read over that one stretch. Then
`--gap-frames` frames under torch.profiler (host and device) with a tracer
installed: the device's idle gaps, each labelled by the innermost program
span open when it began, both on the profiler's clock (`[gaps] program`,
the ten longest, and the idle time per span). With `--cost-window` seconds,
last, six closed-loop windows of that length in the order off, on, on, off,
off, on, "on" with a tracer installed that counts syncs: what tracing costs
when it is on (`[cost]`). The frames of each part follow the last part's.
The last line of standard output is a JSON object of all it read, the
exports whole.
"""

from __future__ import annotations

import contextlib
import sys
import time

from orb_slam3_vio_fixes_tpu_torch.runtime import tracing

COST_ORDER = (False, True, True, False, False, True)


def _spans(ex: dict, *names: str, suffix: str = None) -> list:
    return [s for s in ex["spans"]
            if s["name"] in names or (suffix is not None and s["name"].endswith(suffix))]


def _ms(spans: list) -> float:
    return sum(s["end_ns"] - s["start_ns"] for s in spans) / 1e6


def layers(stretch: dict, setup: dict = None) -> dict:
    """The per-layer rows of one traced stretch's export: a step or BA's mean
    ms a call; the keyframe stages' and loop closing's ms, and the loop
    verifications, per keyframe made (`kf_create_map` calls); the host's
    waits (`*.wait` spans) in ms a frame; the share of frames that re-ran
    tracking work (wide-radius retries and reference-keyframe fallbacks);
    and the `facade` span's seconds from the set-up's export. A row whose
    spans the stretch did not reach is left out."""
    out = {}
    frames = len(_spans(stretch, "track_stereo"))
    kfs = len(_spans(stretch, "kf_create_map"))
    for name in ("frame_build", "track_step", "vi_track_step", "vi_local_ba"):
        s = _spans(stretch, name)
        if s:
            out[f"{name}_ms"] = _ms(s) / len(s)
    if kfs:
        out["kf_stages_ms_per_kf"] = _ms(_spans(stretch, "kf_create_map", "kf_local_ba",
                                                "kf_cull")) / kfs
        out["loop_ms_per_kf"] = _ms(_spans(stretch, "loop")) / kfs
        out["verifications_per_kf"] = len(_spans(stretch, "loop.verify")) / kfs
    if frames:
        out["wait_ms_per_frame"] = _ms(_spans(stretch, suffix=".wait")) / frames
        out["retry_share"] = 100.0 * (stretch["counters"].get("match.wide_retries", 0)
                                      + len(_spans(stretch, "track_ref_kf"))) / frames
    out["frames"], out["keyframes"] = frames, kfs
    f = _spans(setup, "facade") if setup else []
    if f:
        out["facade_s"] = _ms(f) / 1e3
    return out


def window(step, start: int, seconds: float) -> tuple:
    """Frames from `start` back to back, each started while less than
    `seconds` have passed, as the benchmark's timed window runs them:
    (frames, length in s)."""
    t0 = f1 = time.perf_counter()
    i = start
    while f1 - t0 < seconds:
        step(i)
        f1 = time.perf_counter()
        i += 1
    return i - start, f1 - t0


def idle_by_span(step, frames, cuda: bool, top: int = 10) -> dict:
    """Run step(i) over `frames` under torch.profiler (host, and the device
    where `cuda`) with a tracer installed; the device's idle gaps, each
    labelled by the innermost program span open when it began (spans and
    device events both on the profiler's clock): the `top` longest, and the
    idle seconds per span. The profiler slows the host, so this reads only
    where the card waits."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    tr = tracing.Tracer()
    with tracing.traced(tr), profile(activities=acts) as prof:
        for i in frames:
            step(i)
        if cuda:
            torch.cuda.synchronize()
    start = prof.profiler.kineto_results.trace_start_ns()
    dev = sorted((start + 1e3 * e.time_range.start, start + 1e3 * e.time_range.end)
                 for e in prof.events() if str(e.device_type).endswith("CUDA")
                 and e.time_range.end > e.time_range.start)
    sp = tr.export()["spans"]
    wall = (max(s["end_ns"] for s in sp) - min(s["start_ns"] for s in sp)) / 1e9 if sp else 0.0
    gaps, busy, end = [], 0.0, None
    for s, e in dev:
        if end is not None and s > end:
            gaps.append((s - end, end))
        if end is None or e > end:
            busy += (e - max(s, end if end is not None else s)) / 1e9
            end = e
    by_span: dict = {}
    labelled = []
    for g, at in sorted(gaps, reverse=True):
        inner = [x for x in sp if x["start_ns"] <= at <= x["end_ns"]]
        label = (min(inner, key=lambda x: x["end_ns"] - x["start_ns"])["name"] if inner
                 else "between spans")
        by_span[label] = by_span.get(label, 0.0) + g / 1e9
        labelled.append((label, g / 1e9))
    return {"top": labelled[:top], "by_span": by_span, "wall_s": wall, "busy_s": busy}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def trace_cell(bench, cell: dict, seed: int, frames: int, gap_frames: int,
               cost_window: float, device="cuda") -> dict:
    """The set-up, the program stretch, the idle gaps and the cost windows
    of one cell, each part's table to standard error; returns what they
    read."""
    import torch

    from slam_bench import run

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    gpu = torch.cuda.get_device_name(dev) if cuda else "cpu"
    # the scene's frames, at the cell's highest rate, for every part
    seconds = ((frames + gap_frames) / bench.cell_file(cell["name"])["max_fps"]
               + len(COST_ORDER) * cost_window + 10.0)
    setup = tracing.Tracer()
    with tracing.traced(setup):
        r = run.Run(bench, cell, seed, seconds, dev)
        t0 = time.perf_counter()
        r.warm_up()
        warm = time.perf_counter() - t0
    ex0 = setup.export()
    log(f"[program] setup device={gpu!r} warm_up_s={warm!r} frames={r.w0}")
    for ln in tracing.table(ex0):
        log(f"[program] setup {ln}")
    tr = tracing.Tracer()
    t0 = time.perf_counter()
    with tracing.traced(tr, syncs=True):
        for i in range(frames):
            r.step(i)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ex = tr.export()
    log(f"[program] stretch device={gpu!r} frames={frames} seconds={wall!r}")
    for ln in tracing.table(ex):
        log(f"[program] {ln}")
    rows = layers(ex, ex0)
    for k, v in rows.items():
        log(f"[program] layers {k} {v!r}")
    i = frames
    gaps = idle_by_span(r.step, range(i, i + gap_frames), cuda)
    i += gap_frames
    for label, sec in gaps["top"]:
        log(f"[gaps] program {label} {1e3 * sec:.3f} ms")
    for label, sec in sorted(gaps["by_span"].items(), key=lambda kv: -kv[1]):
        log(f"[gaps] program idle_ms {label} {1e3 * sec:.3f}")
    log(f"[gaps] program frames={gap_frames} wall_ms={1e3 * gaps['wall_s']:.3f} "
        f"busy_ms={1e3 * gaps['busy_s']:.3f}")
    cost = []
    if cost_window > 0:
        for on in COST_ORDER:
            ctx = tracing.traced(tracing.Tracer(), syncs=True) if on else contextlib.nullcontext()
            with ctx:
                n, length = window(r.step, i, cost_window)
            i += n
            cost.append({"traced": on, "frames": n, "seconds": length, "fps": n / length})
            log(f"[cost] traced={int(on)} frames={n} seconds={length!r} fps={n / length!r}")
    return {"device": gpu, "setup": ex0, "stretch": ex, "wall_s": wall, "warm_up_s": warm,
            "layers": rows, "gaps": gaps, "cost": cost}


def main(argv=None) -> int:
    import argparse
    import json
    from pathlib import Path

    import torch

    from slam_bench import spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--gap-frames", type=int, default=2)
    ap.add_argument("--cost-window", type=float, default=0.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("slam_bench.program: no CUDA device")
        return 2
    bench = spec.Bench(Path.cwd())
    out = trace_cell(bench, bench.cell(args.workload), args.seed, args.frames,
                     args.gap_frames, args.cost_window)
    print(json.dumps({"workload": args.workload, "seed": args.seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
