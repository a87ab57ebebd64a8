"""One torch thread for the duration of a test module. Under pytest-xdist
several workers run test files at once; each worker's OpenMP pool sized to
every core then spins against the others', and the small tensors of these
tests run many times slower. Import the fixture into a test module to use
it."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
