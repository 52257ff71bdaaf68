"""One ATen thread for a test module of the port.

The suite runs in several worker processes on a few cores. The port's
plain PyTorch versions issue thousands of small ops, and with ATen's
default of one OpenMP thread per core in every worker, those threads
oversubscribe the cores and spin at each op's barrier (with 6 workers on
8 CPU cores the whole suite ran 2.4× slower that way). A module imports
this fixture to run its tests single-threaded; the thread count is
restored after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
