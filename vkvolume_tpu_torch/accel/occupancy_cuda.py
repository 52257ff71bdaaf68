"""The integer path's occupancy map on the card — one launch of
``csrc/occupancy.cu``, which reads the u8 volume (and the u8 gradient map
with a gradient TF) once and writes the u8 map once.

The JAX package builds this map with XLA, so the kernel mirrors no Pallas
kernel; its plain twin is ``occupancy._occupancy_u8_plain``, which the
CPU runs. ``occupancy._occupancy_u8`` chooses: a CPU tensor takes the
plain version, a CUDA tensor this kernel (or raises). ``LAUNCHES`` counts
the kernel's launches.
"""

from __future__ import annotations

import torch

from ..utils import cuda_build, timing

LAUNCHES = {"occupancy": 0}


def _require_volume(name: str, t: torch.Tensor, shape=None) -> None:
    cuda_build.require_cuda(name, t, torch.uint8, shape)
    if t.ndim != 3:
        raise ValueError(f"{name}: expected (Z, Y, X), got {tuple(t.shape)}")
    cuda_build.require_aligned(name, t, 16)


def occupancy_u8(volume_u8: torch.Tensor, gradient_u8: torch.Tensor | None,
                 map_shape_zyx, ti: int, tg: int) -> torch.Tensor:
    """The (mz, my, mx) u8 map, OCCUPIED = 0 / EMPTY = 255, of ``volume_u8``
    in cells of ``ceil(extent / map extent)`` voxels per axis: a cell is
    occupied where a voxel has ``v >= ti`` (and ``g >= tg`` when
    ``gradient_u8`` is given). ``ti`` and ``tg`` in [0, 255], every extent
    at least 1 (else the launch is refused and this raises)."""
    _require_volume("volume_u8", volume_u8)
    if gradient_u8 is not None:
        _require_volume("gradient_u8", gradient_u8, volume_u8.shape)
        if gradient_u8.device != volume_u8.device:
            raise ValueError("gradient_u8: expected the volume's device, got "
                             f"{gradient_u8.device}")
    lib = cuda_build.load_kernels()
    D, H, W = volume_u8.shape
    mz, my, mx = (int(m) for m in map_shape_zyx)
    out = torch.empty((mz, my, mx), dtype=torch.uint8,
                      device=volume_u8.device)
    with timing.kernel(LAUNCHES, "occupancy"):
        cuda_build.check(lib.vkv_occupancy(
            volume_u8.data_ptr(),
            None if gradient_u8 is None else gradient_u8.data_ptr(),
            out.data_ptr(), D, H, W, mz, my, mx, int(ti), int(tg),
            cuda_build.stream()), "occupancy")
    return out
