"""The benchmark's instrumentation, wrapped around the program from outside:
synchronised host spans around calls into a layer, a torch.profiler
stretch of device time, a count of stream synchronisations, and a timeline
of the device's idle gaps labelled by the span the host was in.

Copies of the SLAM package's profile_track.stage_timers, device_profile and
sync_sites, kept here so that a change to the program cannot change how it
is measured.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import importlib
import time
import warnings

import torch

SPAN = "span: "


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def resolve(module: str, attr: str):
    """(owner, name) of a dotted attribute path inside a module, or None when
    it no longer exists."""
    try:
        owner = importlib.import_module(module)
    except ImportError:
        return None
    *path, name = attr.split(".")
    for p in path:
        owner = getattr(owner, p, None)
        if owner is None:
            return None
    return (owner, name) if hasattr(owner, name) else None


def _timed(times, label, fn, sync):
    @functools.wraps(fn)
    def wrapper(*a, **k):
        with torch.profiler.record_function(SPAN + label):
            if sync:
                _sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                _sync()
        times[label].append(time.perf_counter() - t0)
        return out
    return wrapper


def _recorded(calls, label, fn):
    @functools.wraps(fn)
    def wrapper(*a, **k):
        calls[label].append((a, k))
        return fn(*a, **k)
    return wrapper


@contextlib.contextmanager
def wrapped(targets, wrap):
    """Replace each (module, attribute, label) by wrap(label, fn) while the
    context lasts. Targets that no longer exist are skipped."""
    saved = []
    try:
        for module, attr, label in targets:
            found = resolve(module, attr)
            if found is None:
                continue
            owner, name = found
            own = name in vars(owner)
            fn = getattr(owner, name)
            saved.append((owner, name, fn, own))
            setattr(owner, name, wrap(label, fn))
        yield
    finally:
        for owner, name, fn, own in reversed(saved):
            if own:
                setattr(owner, name, fn)
            else:
                delattr(owner, name)


@contextlib.contextmanager
def spans(targets, sync: bool = True):
    """Wrap each (module, attribute, label) with a host timer inside a
    profiler range named after the label, synchronised on both sides unless
    `sync` is off; yields {label: [seconds, ...]}."""
    times = collections.defaultdict(list)
    with wrapped(targets, lambda label, fn: _timed(times, label, fn, sync)):
        yield times


@contextlib.contextmanager
def calls(targets):
    """Keep the arguments of every call of each (module, attribute, label),
    by reference; yields {label: [(args, kwargs), ...]}. A reader works out
    what it needs from them after the stretch, so that none of it syncs the
    stream inside it."""
    seen = collections.defaultdict(list)
    with wrapped(targets, lambda label, fn: _recorded(seen, label, fn)):
        yield seen


def _device_events(prof):
    return [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and getattr(e, "device_time_total", 0) > 0 and not e.key.startswith(SPAN)]


def device_profile(step, frames) -> dict:
    """Run step(i) for each frame under torch.profiler (device activity
    only); the wall, the device's busy seconds (every kernel, copy and
    memset), the launches and each device op's calls and seconds."""
    from torch.profiler import ProfilerActivity, profile

    # without a card (the CPU rehearsal) the profile holds no device op
    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]
    _sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in frames:
            step(i)
        _sync()
        wall = time.perf_counter() - t0
    ops = [(e.key, int(e.count), e.device_time_total / 1e6) for e in _device_events(prof)]
    return {"frames": len(frames), "wall_s": wall, "busy_s": sum(s for _, _, s in ops),
            "launches": sum(c for _, c, _ in ops), "ops": ops}


def idle_gaps(step, frames, targets, top: int = 10) -> list:
    """The longest gaps between device ops while step(i) runs for each
    frame, each labelled by the innermost span the host was in when the gap
    began ([label, seconds]); host and device activity are both traced, so
    this stretch runs slower than the others and reads no metric."""
    from torch.profiler import ProfilerActivity, profile

    _sync()
    with spans(targets, sync=False), \
            profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])) as prof:
        for i in frames:
            step(i)
        _sync()
    dev, ranges = [], []
    for e in prof.events():
        tr = e.time_range
        if str(e.device_type).endswith("CUDA"):
            if not e.name.startswith(SPAN) and tr.end > tr.start:
                dev.append((tr.start, tr.end))
        elif e.name.startswith(SPAN):
            ranges.append((tr.start, tr.end, e.name[len(SPAN):]))
    dev.sort()
    gaps = []
    end = None
    for s, e in dev:
        if end is not None and s > end:
            gaps.append((s - end, end))
        end = e if end is None else max(end, e)
    gaps.sort(reverse=True)
    out = []
    for g, at in gaps[:top]:
        inner = [r for r in ranges if r[0] <= at <= r[1]]
        label = min(inner, key=lambda r: r[1] - r[0])[2] if inner else "between spans"
        out.append([label, g / 1e6])
    return out


def count_syncs(step, frames) -> int:
    """Stream synchronisations that step(i) makes over the frames, as
    torch.cuda's sync debug mode reports them."""
    n = 0

    def show(message, category, filename, lineno, file=None, line=None):
        nonlocal n
        if "synchroniz" in str(message):
            n += 1

    _sync()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        for i in frames:
            if not torch.cuda.is_available():
                step(i)
                continue
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step(i)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    return n
