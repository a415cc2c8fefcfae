import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    """The rehearsals' windows are timed: a few host threads per test
    process keep several processes from starving each other."""
    torch.set_num_threads(2)
