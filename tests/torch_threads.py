"""One intra-op thread for the port's CPU tests.

The port's plain torch paths run many small tensor operations.  With
torch's default thread pool (one thread per core) in each of several test
workers, every parallel operation waits at its barrier for threads that
other processes have descheduled: a 4^3 J2Log step that takes ~6 s alone
took ~220 s beside six busy processes, and ~6 s with one thread.  A test
module that drives those paths imports `one_torch_thread`; pytest then
applies it to every test of that module and restores the thread count
after the module.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
