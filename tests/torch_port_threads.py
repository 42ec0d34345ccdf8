"""One torch CPU thread for the port's CPU tests.

The suite runs in several pytest-xdist workers on one host, beside JAX
tests that keep every core busy. torch's intra-op pool starts a thread a
core in each worker, and the oversubscribed pools slow the port's plain
CPU paths by an order of magnitude (a canonical train step's test: 119 s
with the default pool, 14 s with one thread, six workers on 8 cores).
Import `one_torch_thread` into a test module to run that module's tests on
one thread; the previous count comes back when the module ends.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
