"""Multi-device modes over ``torch.distributed`` (port of
``vkvolume_tpu/parallel``). ``gather_rows`` and ``spawn`` are the SPMD
machinery a single-controller JAX mesh does not need: the output gather
XLA inserts, and the launcher of the ranks."""

from .launch import spawn
from .mesh import (RAY_AXIS, VOL_AXIS, Mesh, gather_rows, make_mesh,
                   march_sharded, march_volume_sharded, render_frame_sharded,
                   replicate, shard_rays, sweep_volume_sharded)

__all__ = ["RAY_AXIS", "VOL_AXIS", "Mesh", "gather_rows", "make_mesh",
           "march_sharded", "march_volume_sharded", "render_frame_sharded",
           "replicate", "shard_rays", "spawn", "sweep_volume_sharded"]
