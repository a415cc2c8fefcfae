"""The card's peaks and the least time a kernel could take at its shapes.

Published rates of one NVIDIA H100 SXM (dense, at its 700 W limit): HBM3 at
3.35 TB/s and 67 TFLOP/s of float32 outside the tensor cores, of which
INT32 arithmetic runs at a quarter (64 INT32 lanes beside 128 FP32 lanes
per SM, an FMA counted as 2 flops). Copied from the SLAM package's
chip_smoke.bound / k1_bound / k2_bound.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# FAST per interior pixel: 46 packed min / max over the 16 arcs and the
# centre, + 1 subtraction; Hamming per admissible pair: 8 XOR + 8 POPC + 7 ADD.
K1_OPS_PER_PX = 47
K2_OPS_PER_PAIR = 23


def bound_s(n_bytes: float, n_ops: float) -> float:
    """Least seconds: bytes over HBM or integer ops over INT32, the larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT32_OPS_PER_S)


def k1_bound_s(shape) -> float:
    """FAST score of a (B, H, W) float32 atlas: each pixel read and written
    once, 47 ops per interior pixel."""
    b, h, w = shape
    return bound_s(8.0 * b * h * w, K1_OPS_PER_PX * b * max(h - 6, 0) * max(w - 6, 0))


def k2_bound_s(q: int, t: int, cols: bool, admissible: int) -> float:
    """Masked Hamming best-2 of (q, 8) against (t, 8) int32 descriptors: the
    mask and both descriptor sets read once, four int32 row outputs and, with
    columns, an 8-byte key per column written once; 23 ops per admissible
    pair."""
    n_bytes = q * t + 32 * (q + t) + 16 * q + (8 * t if cols else 0)
    return bound_s(n_bytes, K2_OPS_PER_PAIR * admissible)
