"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card (marker `cuda`; skipped where no CUDA device is present). Run on a
machine with a card:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda

Tolerance: exact — both kernels compute integers.
"""

import pytest
import torch

from orb_slam3_vio_fixes_tpu_torch import kernels
from orb_slam3_vio_fixes_tpu_torch.ops import fast, matching

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_fast_score_kernel_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, 511, (2, 2380, 752), generator=g, device=dev).float() * 0.5
    n0 = fast.fast_score_batch.launches
    got = fast.fast_score_batch(x)
    assert fast.fast_score_batch.launches == n0 + 1
    assert torch.equal(got, fast.fast_score_plain(x))


@pytest.mark.parametrize("Q,T,density", [(1024, 1024, 0.3), (2048, 1024, 0.001),
                                         (300, 1000, 1.0)])
def test_hamming_kernels_match_plain(dev, Q, T, density):
    g = torch.Generator(device=dev).manual_seed(1)
    pool = torch.randint(-2**31, 2**31, (8, 8), generator=g, device=dev,
                         dtype=torch.int64).to(torch.int32)
    dq = pool[torch.randint(0, 8, (Q,), generator=g, device=dev)]
    dt = pool[torch.randint(0, 8, (T,), generator=g, device=dev)]
    mask = torch.rand((Q, T), generator=g, device=dev) < density
    for a, b in zip(matching.hamming_best2(dq, dt, mask),
                    matching.best2_plain(dq, dt, mask)):
        assert torch.equal(a, b)
    assert torch.equal(matching.hamming_argmin_cols(dq, dt, mask),
                       matching.col_argmin_plain(dq, dt, mask))


def test_wrappers_refuse_bad_inputs(dev):
    kernels.library()
    with pytest.raises(ValueError):
        fast.fast_score_batch(torch.zeros(2, 8, 8, device=dev, dtype=torch.float64))
    d = torch.zeros(4, 8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        matching.hamming_best2(d, d, torch.ones(4, 5, dtype=torch.bool, device=dev))
