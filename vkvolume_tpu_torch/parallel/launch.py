"""Run a function on ``n`` ranks of a fresh process group.

``spawn(fn, n, backend=..., device=..., args=...)`` starts ``n`` processes
with the ``spawn`` start method (CUDA cannot be forked), joins them
through a ``FileStore`` in a temporary directory (no network port), builds
the mesh of all ranks (``mesh.make_mesh``) and calls ``fn(mesh, *args)``
on every rank. Each rank's return value (numpy arrays, numbers: anything
picklable) comes back to the caller, in rank order.

The backend is the caller's choice and never changes after a failure:
``nccl`` needs a GPU per rank; ``gloo`` runs CPU ranks, and CUDA ranks
that share one GPU (NCCL refuses two ranks on one device), its
collectives staging through host memory. Gloo's sockets are bound to the
loopback interface (``GLOO_SOCKET_IFNAME=lo`` unless the environment sets
another), NCCL's bootstrap likewise. A rank that raises, or a group that
outlives ``timeout`` seconds (a hung collective), ends every rank and
raises here.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import make_mesh


def _rank_main(rank: int, fn, n: int, backend: str, device: str, args,
               tmp: str, timeout: float) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ["LOCAL_RANK"] = str(rank)
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), n)
    kw = {}
    if backend == "nccl":
        # NCCL's collectives run on the rank's own card.
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=timeout), **kw)
    try:
        mesh = make_mesh(device=device)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        result = fn(mesh, *args)
        dist.barrier(group=mesh.group)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn, n: int, *, backend: str, device: str = "cuda", args=(),
          timeout: float = 600.0) -> list:
    """``fn(mesh, *args)`` on ``n`` new ranks; their results in rank order.
    ``fn`` must be importable by name (a module-level function), and
    ``args`` picklable. ``device``: every rank's device, "cuda" (each rank
    takes ``cuda:<rank % device count>``) or "cpu"."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: gloo or nccl")
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, n, backend, device, tuple(args), tmp,
                              timeout),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(
                    f"{n} ranks did not finish within {timeout:.0f} s")
        results = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
