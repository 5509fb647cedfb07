"""A module fixture for the port's parity tests: one intra-op torch thread.

pytest-xdist runs several workers on the same cores, and each worker's
torch spins its own intra-op thread pool; on small tensors the pools then
slow each other down several times over. The arithmetic the tests check is
the same with one thread. A test module takes the fixture with
``from torch_threads import one_torch_thread  # noqa: F401``.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
