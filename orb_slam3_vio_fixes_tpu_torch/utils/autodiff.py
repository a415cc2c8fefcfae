"""Forward-mode Jacobians of row-wise batched functions.

The reference takes its visual-inertial Jacobians from `jax.vmap(
jax.jacfwd(f))` over a per-factor function. Here the factor functions are
written over a leading batch of factors, and `jac_rows` pushes one unit
tangent per input column through them as dual numbers: the batch is
repeated once per tangent, so one forward pass with `torch.autograd.
forward_ad` gives every column. `torch.func.vmap(jvp)` computes the same
numbers, but its batching rules decompose many ops in Python (about 3x the
host time per call), and it gives a 0-dim tensor times a Python float a
float64 tangent.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD


def jac_rows(f, z: torch.Tensor, *rows: torch.Tensor):
    """(f(z, *rows), J) for f: (B, n), (B, ...)... -> (B, m) whose row b
    depends only on z[b] and rows[.][b]; J is (B, m, n),
    J[b, :, k] = d f[b] / d z[b, k]. Anything shared by all rows is closed
    over by f."""
    B, n = z.shape
    tangents = torch.eye(n, dtype=z.dtype, device=z.device).repeat_interleave(B, 0)
    reps = [r.repeat((n,) + (1,) * (r.ndim - 1)) for r in rows]
    with fwAD.dual_level():
        out = f(fwAD.make_dual(z.repeat(n, 1), tangents), *reps)
        val, tan = fwAD.unpack_dual(out)
    return val[:B], tan.reshape(n, B, -1).permute(1, 2, 0)
