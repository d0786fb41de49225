"""One torch intra-op thread for the port's CPU tests.

The port's tests run thousands of tiny torch ops on the CPU, where the
intra-op thread pool costs more than the work: under ``pytest -n 6`` six
workers each start a pool as wide as the machine, and a test that takes
0.5 s on one thread takes over a minute. Each ``tests/test_torch_*.py``
imports :func:`one_torch_thread`; being autouse and module-scoped, it pins
the count for that module's tests and gives the previous count back when the
module ends, so nothing leaks into the other files an xdist worker runs.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)
