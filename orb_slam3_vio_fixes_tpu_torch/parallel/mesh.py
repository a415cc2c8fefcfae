"""A single-controller device mesh and a per-shard runner (the port's
counterpart of `jax.sharding.Mesh` and `jax.shard_map`).

One process drives every shard, as the JAX package's mesh does: a
`SLAMSystem` calls the sharded solvers from its own frame loop, so there is
no serving loop on other ranks and no process group. `shard_map` runs the
body once per shard, each in a thread of its own whose current device is
the shard's and whose current CUDA stream is that device's default stream;
the body's arrays live on the shard's device. A mesh may name one device
several times (eight shards on "cpu" in the tests, four on "cuda:0" on one
card).

The shards take turns on the host, in shard order, switching at each
collective (`Axis.psum`, `Axis.pmin`): every shard hands in its partial,
the partials are reduced in shard order on shard 0's device, and every
shard receives a copy of that one result. The result is therefore
the same bytes on every shard and in every run, whatever the threads'
timing, so decisions taken from a reduced value (an LM step's acceptance
from the reduced chi2) agree across shards. An exception in any shard
ends every shard's turn and is raised again in the caller.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Sequence

import torch


class Mesh:
    """`devices` (one per shard, repeats allowed) along one named axis.
    `.shape` maps the axis name to its size, as jax's Mesh.shape does."""

    def __init__(self, devices: Sequence, axis_names=("lm",)):
        if isinstance(axis_names, str):
            axis_names = (axis_names,)
        axis_names = tuple(axis_names)
        if len(axis_names) != 1:
            raise ValueError(f"a Mesh has one axis, got {axis_names}")
        devices = tuple(torch.device(d) for d in devices)
        if not devices:
            raise ValueError("a Mesh needs at least one device")
        self.devices = devices
        self.axis_names = axis_names
        self.shape = {axis_names[0]: len(devices)}

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names})"


class P(tuple):
    """Partition spec of one argument or result: P() replicated, P(axis)
    split along its first dimension into one equal block per shard."""

    def __new__(cls, *names):
        return super().__new__(cls, names)


def _map(fn, x):
    """fn on every tensor of a nest of tuples (NamedTuples too) and lists;
    other leaves (floats, ints, None) as they are."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_map(fn, v) for v in x)
    return x


def _leaves(x):
    out = []
    _map(lambda t: out.append(t) or t, x)
    return out


def _ready_event(t: torch.Tensor):
    """An event recorded on t's device's current stream (None on the CPU):
    whoever reads t from another thread waits on it."""
    if t.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


def _wait(ev, device: torch.device) -> None:
    if ev is not None and device.type == "cuda":
        torch.cuda.current_stream(device).wait_event(ev)


class _Aborted(Exception):
    """Raised in a shard when another shard failed."""


class _Group:
    """The shards' rendezvous. The shards take turns, in shard order: a
    shard runs until its next collective, hands in its partial and passes
    the turn to the next shard; the last one reduces the partials and
    passes the turn back to shard 0. So one shard thread runs host code at
    a time (the others wait on an event, not on the interpreter lock), the
    order of every host step is fixed, and the devices still overlap: a
    shard's kernels run while the next shard enqueues its own."""

    def __init__(self, devices):
        self.devices = devices
        self.n = len(devices)
        self.turn = [threading.Event() for _ in devices]
        self.aborted = False
        self.slots = [None] * self.n
        self.result = None

    def pass_turn(self, i: int) -> None:
        self.turn[i].clear()
        if i + 1 < self.n:
            self.turn[i + 1].set()

    def wait_turn(self, i: int) -> None:
        self.turn[i].wait()
        if self.aborted:
            raise _Aborted()

    def abort(self) -> None:
        self.aborted = True
        for ev in self.turn:
            ev.set()

    def collective(self, i: int, tag: str, x, reduce):
        self.slots[i] = (tag, x, _ready_event(x) if isinstance(x, torch.Tensor) else None)
        if i + 1 < self.n:
            self.pass_turn(i)
        else:
            self.result = self._reduce(reduce)
            self.turn[i].clear()
            self.turn[0].set()
        self.wait_turn(i)
        _, res, ev = self.result
        if res is None:
            return None
        dev = self.devices[i]
        _wait(ev, dev)
        return res.to(dev, copy=True)

    def _reduce(self, reduce):
        tags = [s[0] for s in self.slots]
        if len(set(tags)) != 1:
            raise RuntimeError(f"the shards disagree on the collective: {tags}")
        if reduce is None:
            return tags[0], None, None
        dev = self.devices[0]
        acc = None
        for _, x, ev in self.slots:
            _wait(ev, dev)
            x = x.to(dev)
            acc = x.clone() if acc is None else reduce(acc, x)
        return tags[0], acc, _ready_event(acc)


class Axis:
    """What the body of `shard_map` gets as its first argument: this shard's
    index along the axis and the axis's collectives."""

    def __init__(self, index: int, group: _Group):
        self.axis_index = index
        self._group = group

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the shards, in shard order on shard 0's device."""
        return self._group.collective(self.axis_index, "psum", x, torch.add)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise minimum over the shards."""
        return self._group.collective(self.axis_index, "pmin", x, torch.minimum)


def _split(x, n: int, i: int, axis: str):
    def block(t):
        if t.shape[0] % n:
            raise ValueError(f"P({axis!r}) argument of {t.shape[0]} rows does not split "
                             f"into {n} shards")
        b = t.shape[0] // n
        return t[i * b:(i + 1) * b]
    return _map(block, x)


def _cuda_index(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _caller_events(x) -> dict:
    """One event per CUDA device of x's tensors, on the caller's current
    stream there: a shard waits on them before it reads its inputs."""
    devs = {t.device for t in _leaves(x) if t.device.type == "cuda"}
    return {d: _ready_event(torch.empty(0, device=d)) for d in devs}


def shard_map(body: Callable, mesh: Mesh, in_specs, out_specs, out_device=None):
    """Returns f(*args) that runs body(axis, *local_args) once per shard of
    `mesh`, each in its own thread on its own device, and returns a tuple
    of results. in_specs / out_specs hold one P per argument / result: P()
    arguments go whole to every shard, P(axis) ones in equal
    first-dimension blocks; a P() result is shard 0's, a P(axis) result the
    shards' blocks concatenated in shard order. Results land on
    `out_device` (default: the first shard's device)."""
    axis = mesh.axis_names[0]
    for spec in (*in_specs, *out_specs):
        if len(spec) > 1 or (spec and spec[0] != axis):
            raise ValueError(f"spec {spec} is neither P() nor P({axis!r})")

    def run(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"{len(args)} arguments for {len(in_specs)} in_specs")
        devices = tuple(_cuda_index(d) for d in mesh.devices)
        home = _cuda_index(torch.device(out_device)) if out_device is not None else devices[0]
        n = len(devices)
        group = _Group(devices)
        outs, done, errors = [None] * n, [None] * n, [None] * n
        inputs_ready = _caller_events(args)
        grad = torch.is_grad_enabled()

        def shard(i):
            dev = devices[i]
            try:
                group.wait_turn(i)
                if dev.type == "cuda":
                    torch.cuda.set_device(dev)
                ctx = (torch.cuda.stream(torch.cuda.default_stream(dev))
                       if dev.type == "cuda" else contextlib.nullcontext())
                with ctx, torch.set_grad_enabled(grad):
                    for ev in inputs_ready.values():
                        _wait(ev, dev)
                    local = [_map(lambda t: t.to(dev), _split(a, n, i, axis) if spec else a)
                             for a, spec in zip(args, in_specs)]
                    out = tuple(body(Axis(i, group), *local))
                    # every shard ends together: one that returns while
                    # another still waits in a collective is a fault
                    group.collective(i, "end", None, None)
                    done[i] = _ready_event(torch.empty(0, device=dev))
                outs[i] = out
                group.pass_turn(i)
            except BaseException as e:     # noqa: BLE001 - raised again by the caller
                errors[i] = e
                group.abort()

        threads = [threading.Thread(target=shard, args=(i,), daemon=True,
                                    name=f"shard-{axis}-{i}") for i in range(n)]
        for t in threads:
            t.start()
        group.turn[0].set()
        for t in threads:
            t.join()
        real = [e for e in errors if e is not None and not isinstance(e, _Aborted)]
        if real:
            raise real[0]
        for dev, ev in zip(devices, done):
            _wait(ev, dev)
            _wait(ev, home)
        if len(outs[0]) != len(out_specs):
            raise ValueError(f"body returned {len(outs[0])} results for "
                             f"{len(out_specs)} out_specs")
        return tuple(torch.cat([o[k].to(home) for o in outs]) if spec
                     else _map(lambda t: t.to(home), outs[0][k])
                     for k, spec in enumerate(out_specs))

    return run
