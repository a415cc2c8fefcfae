"""pytest plugin: free JAX's compiled executables at every module boundary.

Each compiled JAX executable holds memory mappings until
`jax.clear_caches()`, and a process past the kernel's mapping limit
(vm.max_map_count, 65,530 by default) segfaults inside a compile. With
xdist's `--dist load`, one worker can get several compile-heavy modules in a
row, so the caches are cleared whenever the next test a worker runs belongs
to another module (or there is none). JAX is read from `sys.modules`: a
process that never imported it has nothing to free.

The fixture `threads_end` (used by the port's tests that start threads,
directly or through `shard_map`, `PipelineRunner` or the MAVLink interface)
joins every Python thread the test started, within THREAD_JOIN_S seconds in
all, and fails the test if one is still running.

It also makes a hang visible: around each test it arms
`faulthandler.dump_traceback_later(HANG_DUMP_S, exit=False)`, so a test
still running after HANG_DUMP_S seconds writes every thread's stack to the
process's real stderr (duplicated before pytest's capture, which would
otherwise swallow it with the test) and goes on running; nothing is
killed.

Loaded through `pytest_plugins` in tests/test_torch_imports.py; every
worker collects that module, so the hooks are live before any test runs.
"""

import contextlib
import faulthandler
import gc
import os
import sys
import threading
import time

import pytest

HANG_DUMP_S = 600   # above the slowest tier-1 test (568 s under six busy workers)
THREAD_JOIN_S = 30

_stderr = None      # a duplicate of the stderr pytest started with


def pytest_configure(config):
    global _stderr
    capman = config.pluginmanager.getplugin("capturemanager")
    with capman.global_and_fixture_disabled() if capman else contextlib.nullcontext():
        _stderr = os.fdopen(os.dup(2), "w")


def pytest_unconfigure(config):
    global _stderr
    if _stderr is not None:
        faulthandler.cancel_dump_traceback_later()
        _stderr.close()
        _stderr = None


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    if _stderr is not None:
        faulthandler.dump_traceback_later(HANG_DUMP_S, exit=False, file=_stderr)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()


def pytest_runtest_teardown(item, nextitem):
    if nextitem is not None and nextitem.module is item.module:
        return
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()
        gc.collect()


@pytest.fixture
def threads_end():
    before = set(threading.enumerate())
    yield
    deadline = time.monotonic() + THREAD_JOIN_S
    started = [t for t in threading.enumerate() if t not in before]
    for t in started:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    alive = [t.name for t in started if t.is_alive()]
    assert not alive, f"threads still running at the end of the test: {alive}"
