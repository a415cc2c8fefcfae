"""Host runtime (port of orb_slam3_vio_fixes_tpu/runtime/): the native
bounded queue and Hamming matchers, and the pipeline runner."""

from orb_slam3_vio_fixes_tpu_torch.runtime.native import (
    NativeQueue,
    hamming_match,
    hamming_matrix,
    native_available,
)
from orb_slam3_vio_fixes_tpu_torch.runtime.actors import PipelineRunner, StageTimes

__all__ = [
    "NativeQueue",
    "hamming_match",
    "hamming_matrix",
    "native_available",
    "PipelineRunner",
    "StageTimes",
]
