"""An autouse fixture for the port's CPU test modules: two intra-op torch
threads while a module runs. The Tier-1 run spreads the test files over six
workers on the machine's cores, where torch's default of a thread a core
(and JAX's own pool beside it) spends more time waiting than computing.
A module takes it by importing it:

    from torch_threads import few_torch_threads  # noqa: F401
"""

import pytest
import torch

THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(old)
