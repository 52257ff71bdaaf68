"""The port's entry points run on the CUDA card unless the caller asks for
the CPU: ``Engine``, ``from_array``, ``from_file``,
``bench.harness.make_engine`` and ``parallel.make_mesh`` default to "cuda"
and, on a machine without a CUDA device, raise instead of falling back to
the CPU."""

import inspect

import numpy as np
import pytest
import torch

from vkvolume_tpu_torch.bench.harness import make_engine
from vkvolume_tpu_torch.engine import Engine, from_array, from_file
from vkvolume_tpu_torch.parallel import make_mesh

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


def test_make_mesh_defaults_to_the_card(tmp_path, monkeypatch):
    """A one-rank gloo group: ``make_mesh`` takes a CUDA device unless asked
    for the CPU, raises without a card, and never builds a mesh without an
    initialised group."""
    import torch.distributed as dist

    assert inspect.signature(make_mesh).parameters["device"].default is None
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_mesh(device="cpu")
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        if not torch.cuda.is_available():
            for kw in ({}, {"device": "cuda"}):
                with pytest.raises(RuntimeError, match="no CUDA device"):
                    make_mesh(**kw)
        mesh = make_mesh(device="cpu")
        assert (mesh.size, mesh.rank, mesh.backend) == (1, 0, "gloo")
        assert mesh.device == torch.device("cpu")
    finally:
        dist.destroy_process_group()
