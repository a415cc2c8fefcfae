"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card (marker `cuda`; skipped where no CUDA device is present). Run on a
machine with a card:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda

Tolerance: exact — both kernels compute integers. The last test runs 10
stereo-inertial frames twice in PyTorch's deterministic mode and asks for
bitwise equal poses.
"""

import os

import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu_torch import kernels
from orb_slam3_vio_fixes_tpu_torch.ops import fast, matching
from orb_slam3_vio_fixes_tpu_torch.utils import determinism

# cuBLAS reads its workspace setting when its handle is made: before any test
# of this module touches the card
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", determinism.WORKSPACE)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,half", [((2, 2380, 752), True), ((2, 2380, 751), False),
                                        ((2, 7, 37), True)])
def test_fast_score_kernel_matches_plain(dev, shape, half):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, 511 if half else 256, shape, generator=g, device=dev).float()
    x = x * (0.5 if half else 1.0)
    n0 = kernels.LAUNCHES["fast_score"]
    got = fast.fast_score_batch(x)
    assert kernels.LAUNCHES["fast_score"] == n0 + 1
    assert torch.equal(got, fast.fast_score_plain(x))


@pytest.mark.parametrize("Q,T,density", [(1024, 1024, 0.3), (2048, 1024, 0.001),
                                         (300, 1000, 1.0), (1, 1, 1.0),
                                         (1024, 2048, 0.3), (1024, 1000, 0.5),
                                         (64, 100, 0.0)])
def test_hamming_kernels_match_plain(dev, Q, T, density):
    g = torch.Generator(device=dev).manual_seed(1)
    pool = torch.randint(-2**31, 2**31, (8, 8), generator=g, device=dev,
                         dtype=torch.int64).to(torch.int32)
    dq = pool[torch.randint(0, 8, (Q,), generator=g, device=dev)]
    dt = pool[torch.randint(0, 8, (T,), generator=g, device=dev)]
    mask = torch.rand((Q, T), generator=g, device=dev) < density
    mask[Q // 2] = False
    for cols in (False, True):
        n0 = kernels.LAUNCHES["hamming_match"]
        got = matching.hamming_match(dq, dt, mask, cols)
        assert kernels.LAUNCHES["hamming_match"] == n0 + 1
        for a, b in zip(got, matching.match_plain(dq, dt, mask, cols)):
            assert (a is None and b is None) or torch.equal(a, b)


def test_wrappers_refuse_bad_inputs(dev):
    kernels.library()
    with pytest.raises(ValueError):
        fast.fast_score_batch(torch.zeros(2, 8, 8, device=dev, dtype=torch.float64))
    d = torch.zeros(4, 8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        matching.hamming_match(d, d, torch.ones(4, 5, dtype=torch.bool, device=dev), True)


def test_stereo_inertial_frames_repeat_bitwise(dev):
    import chip_smoke as cs

    determinism.enable()
    seq = cs.make_inertial_sequence(10)
    poses = []
    for _ in range(2):
        tr = cs.build_inertial_tracker(seq, dev)
        out = [cs.track_frame(tr, seq, i) for i in range(10)]
        poses.append(np.stack([np.concatenate([R.ravel(), t]) for R, t, _ in out]))
    assert torch.are_deterministic_algorithms_enabled()
    assert np.array_equal(poses[0], poses[1])
