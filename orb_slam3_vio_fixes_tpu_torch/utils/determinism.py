"""Deterministic mode: one input, one answer, run after run.

On the card, `index_add_`, `scatter_add_` and `scatter_reduce_(sum)` sum in
whatever order their atomics land, and the joint solves amplify that spread
(the stereo-inertial ATE moved across its bar between runs of one build).
`torch.use_deterministic_algorithms(True)` switches them to ordered
implementations, and cuBLAS needs a fixed workspace for the same: the
environment variable CUBLAS_WORKSPACE_CONFIG must be set before the first
cuBLAS handle is made, which `enable` does, or refuses to do too late.

The mode also fills every `torch.empty` with NaN by default, so that a read
of uninitialised memory shows. The port reads none: on an NVIDIA H100 80GB
HBM3 (700 W) the stereo and stereo-inertial passes of chip_smoke.py gave
the same keyframe poses, bit for bit, with the fill and without it, and the
fill's launches cost about a tenth of the stereo frame rate
(`phase_repeat.py determinism`). `enable` turns the fill off.
"""

from __future__ import annotations

import os

import torch
import torch.utils.deterministic

WORKSPACE = ":4096:8"
_DETERMINISTIC_WORKSPACES = (WORKSPACE, ":16:8")


def enable() -> None:
    """Switch PyTorch to deterministic algorithms for the whole process,
    without the fill of uninitialised memory.

    Sets CUBLAS_WORKSPACE_CONFIG to ":4096:8" when it is unset. Raises
    RuntimeError when CUDA is already initialised without the variable (a
    cuBLAS handle made then keeps the default workspace, whose reductions
    are not ordered), or when the variable names a workspace that cuBLAS
    does not run deterministically."""
    cfg = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    if cfg is None:
        if torch.cuda.is_initialized():
            raise RuntimeError(
                "deterministic mode: CUDA was initialised before CUBLAS_WORKSPACE_CONFIG "
                f"was set; set CUBLAS_WORKSPACE_CONFIG={WORKSPACE} (or call "
                "utils.determinism.enable()) before any CUDA work")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = WORKSPACE
    elif cfg not in _DETERMINISTIC_WORKSPACES:
        raise RuntimeError(f"deterministic mode: CUBLAS_WORKSPACE_CONFIG={cfg!r} is not "
                           f"one of {_DETERMINISTIC_WORKSPACES}")
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
