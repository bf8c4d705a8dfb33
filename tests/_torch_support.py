"""Shared fixture of the port's tests (tests/test_torch_*.py)."""

import pytest
import torch


@pytest.fixture(scope="module")
def few_torch_threads():
    """Cap PyTorch's intra-op threads for a module: the port's CPU tests
    are small, and the suite runs several workers side by side, whose
    timing-sensitive tests suffer from idle-spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
