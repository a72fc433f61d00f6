"""``one_thread``: an autouse fixture that runs a test module's torch work on
one thread. The port's test modules compute small products; with the test
workers sharing the cores, the threads of each worker's pool spend their
time waiting for each other. A module takes it with

    from torch_threads import one_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
