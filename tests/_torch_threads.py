"""The port's test files share one fixture: import ``_one_torch_thread``
by name into a ``test_torch_*.py`` module and it applies to that module."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops run faster on one thread, and a suite run with six
    xdist workers shares the cores among them: intra-op threads there
    only oversubscribe them. Restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
