"""The rank side of ``tests/test_torch_parallel.py``: the port's
multi-device modes on the cases that module builds, run on every rank of
one spawned gloo group (``vkvolume_tpu_torch.parallel.spawn``).

Spawned ranks import this module by name, so it imports only numpy, torch
and the port — never jax, which the test process holds with its 8-device
CPU mesh. Every case arrives as numpy (``inputs``) and every result goes
back as numpy.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from vkvolume_tpu_torch import interop
from vkvolume_tpu_torch.options import SkippingType
from vkvolume_tpu_torch.parallel import (gather_rows, march_sharded,
                                         march_volume_sharded,
                                         render_frame_sharded, replicate,
                                         sweep_volume_sharded)

OUT_FIELDS = ("color", "depth", "num_volume_samples", "num_distance_samples",
              "num_empty_samples")


def inputs(case: dict) -> dict:
    """A case's numpy inputs as the port's objects (CPU tensors)."""
    got = dict(case)
    got["tf"] = interop.tf_from_numpy(case["tf"])
    got["rays"] = interop.rays_from_numpy(case["rays"])
    if "uniforms" in case:
        got["uniforms"] = interop.uniforms_from_numpy(case["uniforms"])
    for k in ("vol", "grad", "maps"):
        if case.get(k) is not None:
            got[k] = torch.tensor(np.asarray(case[k]))
    return got


def numpy_out(out) -> dict:
    res = {k: getattr(out, k).numpy() for k in OUT_FIELDS}
    res["iterations"] = int(out.iterations)
    return res


def march_options(case: dict) -> dict:
    return dict(skipping_type=SkippingType(case["skip"]),
                early_ray_termination=True,
                count_samples=case.get("count", False))


def _march(mesh, case):
    x = inputs(case)
    if mesh.rank == 0:
        vol = (x["vol"], x["grad"], x["maps"])
    else:
        vol = None
    # The volume and maps reach the other ranks from rank 0.
    vol, grad, maps = replicate(vol, mesh)
    try:
        out = march_sharded(mesh, vol, grad, maps, x["tf"], x["rays"],
                            case["bs"], case["pvm"], **march_options(case))
    except ValueError as e:
        return {"error": str(e)}
    res = {"local": numpy_out(out), "rank": mesh.rank}
    res["full"] = numpy_out(gather_rows(out, mesh))
    return res


def _march_volume(mesh, case):
    x = inputs(case)
    # The volume stays on the host: each rank cuts its own slab.
    out = march_volume_sharded(
        mesh, case["vol"], case["grad"], x.get("maps"), x["tf"], x["rays"],
        case["bs"], case["pvm"], **march_options(case))
    return numpy_out(out)


def _frame(mesh, case):
    x = inputs(case)
    out = render_frame_sharded(
        mesh, x["vol"], x["maps"], x["tf"], x["rays"], x["uniforms"],
        case["pvm"], p_axis=case["p"], ert=True, dist_leap=True,
        plan=case.get("plan"))
    return {"local_rows": out.color.shape[0],
            "full": numpy_out(gather_rows(out, mesh))}


def _sweep_volume(mesh, case):
    x = inputs(case)
    out = sweep_volume_sharded(
        mesh, case["vol"], case["maps"], x["tf"], x["uniforms"], case["pvm"],
        p_axis=case["p"], height=case["height"], width=case["width"],
        ert=case["ert"], dist_leap=True)
    return numpy_out(out)


RUNNERS = {"march": _march, "march_volume": _march_volume, "frame": _frame,
           "sweep_volume": _sweep_volume}


def run_cases(mesh, cases: dict) -> dict:
    """Every case on this rank, in the same order on every rank (each
    mode's collectives pair up across the ranks)."""
    return {name: RUNNERS[case["mode"]](mesh, case)
            for name, case in cases.items()}


def hang(mesh):
    """Rank 0 waits in a collective that the other ranks never join."""
    if mesh.rank == 0:
        mesh.max_int(0)
    else:
        time.sleep(3600)


def rays_numpy(rays) -> dict:
    """A RaySetup of either package as a dict of numpy arrays."""
    return {f.name: None if getattr(rays, f.name) is None
            else np.asarray(getattr(rays, f.name))
            for f in dataclasses.fields(rays)}
