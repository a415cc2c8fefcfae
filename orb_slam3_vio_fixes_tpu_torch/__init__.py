"""PyTorch + CUDA port of the stereo visual SLAM main path for one NVIDIA H100.

The JAX package `orb_slam3_vio_fixes_tpu` stays the reference; this package
mirrors its file names so every counterpart is easy to find. It imports
`torch` and numpy only, never `jax` and never the JAX package.

What is ported: the synchronous stereo tracking path that `bench.py` times
(`frontend.tracking.StereoTracker.process_stereo`), with the Pallas FAST score
kernel and the masked Hamming best-2 matcher written by hand in CUDA C++ for
`sm_90a` (`csrc/`, built at first use by `kernels.py`). Every kernel has a
plain PyTorch twin in the module of its wrapper; the wrapper takes the twin
only for tensors on the CPU.

Conventions: descriptors are int32 bit patterns of the reference's uint32
words; functions take tensors and derive the device from them, constructors
take an explicit `device`; the map is updated in place where the JAX code
donated its buffers.
"""

__version__ = "0.1.0"
