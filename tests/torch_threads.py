"""The port's tests' torch thread limit, imported by each ``test_torch_*``
module that runs torch work: the suite runs several workers on one machine,
and each worker's torch would otherwise start a thread per core."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two torch threads for the module, set before its other fixtures run."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
