"""The benchmark's own tests: ``pytest vkbench/tests -q`` from the root.

On the CPU they drive the harness through the program's plain PyTorch
versions at tiny sizes. Tests marked ``cuda`` need the card; a fixture
decides, never the import of a module.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skipped without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    import torch

    torch.set_num_threads(min(4, torch.get_num_threads()))
