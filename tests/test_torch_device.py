"""The port's entry points run on the CUDA card unless the caller asks for
the CPU: ``Engine``, ``from_array``, ``from_file`` and
``bench.harness.make_engine`` default to "cuda" and, on a machine without a
CUDA device, raise instead of falling back to the CPU."""

import inspect

import numpy as np
import pytest
import torch

from vkvolume_tpu_torch.bench.harness import make_engine
from vkvolume_tpu_torch.engine import Engine, from_array, from_file

ENTRY_POINTS = [Engine.__init__, from_array, from_file, make_engine]


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=lambda f: f.__qualname__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("call", [
    lambda: Engine(),
    lambda: from_array(np.zeros((2, 3, 4), np.uint8)),
    lambda: from_file("no-such-volume.raw"),
    lambda: make_engine("beetle", 2, 4, scale=0.05),
], ids=["Engine", "from_array", "from_file", "make_engine"])
def test_default_device_raises_without_cuda(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_cpu_is_taken_only_when_asked():
    eng = Engine(device="cpu")
    v = from_array(np.zeros((2, 3, 4), np.uint8), device="cpu")
    assert eng.device == v.device == torch.device("cpu")
