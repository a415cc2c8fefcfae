"""pytest plugin: free JAX's compiled executables at every module boundary.

Each compiled JAX executable holds memory mappings until
`jax.clear_caches()`, and a process past the kernel's mapping limit
(vm.max_map_count, 65,530 by default) segfaults inside a compile. With
xdist's `--dist load`, one worker can get several compile-heavy modules in a
row, so the caches are cleared whenever the next test a worker runs belongs
to another module (or there is none). JAX is read from `sys.modules`: a
process that never imported it has nothing to free.

Loaded through `pytest_plugins` in tests/test_torch_imports.py; every
worker collects that module, so the hook is live before any test runs.
"""

import gc
import sys


def pytest_runtest_teardown(item, nextitem):
    if nextitem is not None and nextitem.module is item.module:
        return
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()
        gc.collect()
