"""A fixture for the port's CPU tests that run torch convolutions: one
intra-op thread while the test runs (the suite runs six workers at once,
and torch's default of one thread a core in each of them oversubscribes
the machine many times over)."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
