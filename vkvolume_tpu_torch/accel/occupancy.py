"""Occupancy map and occupied-voxel count — integer block reductions in
plain PyTorch.

Port of the integer fast path of ``vkvolume_tpu/accel/occupancy.py``
(shaders/occupancy_map.comp:45-73, occupied_voxel_count.comp): the
closed-form ``alpha > 0`` test is monotone in the u8 intensity (and
gradient), so "any voxel of the block has alpha > 0" is a per-block u8 max
compared with a threshold that the host derives with the device's exact
float32 arithmetic. Non-monotone TF ranges (the general float path) are not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

OCCUPIED = 0
EMPTY = 255


def map_extent(extent_xyz, block_size: int):
    """Map extent = ceil(extent / block_size) per axis
    (src/volume_component.cpp:91-92)."""
    return tuple(-(-e // block_size) for e in extent_xyz)


def effective_block_size(extent_xyz, map_extent_xyz):
    """Per-axis block size recomputed from the map extent
    (src/compute_distance_map.cpp:107-113)."""
    return tuple(-(-e // m) for e, m in zip(extent_xyz, map_extent_xyz))


def alpha_positive_threshold(lo: float, inv: float) -> int | None:
    """Smallest u8 value v with ``clip((f32(v) * (1/255) - lo) * inv, 0, 1)
    > 0`` in float32; 256 when none is positive, None when the positive set
    is not ``{v >= T}``."""
    v = np.arange(256, dtype=np.float32)
    a = np.clip((v * np.float32(1.0 / 255.0) - np.float32(lo))
                * np.float32(inv), np.float32(0.0), np.float32(1.0))
    pos = a > 0.0
    if not pos.any():
        return 256
    first = int(np.argmax(pos))
    return first if bool(pos[first:].all()) else None


def _tf_thresholds(tf_host):
    """(ti, tg) u8 thresholds from the host slider values
    ``tf_host = (imin, imax, gmin, gmax)`` with the TF's float32 derivation
    (tf_params), or None when a range is not monotone."""
    imin, imax, gmin, gmax = tf_host
    ti = alpha_positive_threshold(float(np.float32(imin)),
                                  float(np.float32(1.0 / (imax - imin))))
    if ti is None:
        return None
    tg = 0
    if gmax != gmin:
        tg = alpha_positive_threshold(float(np.float32(gmin)),
                                      float(np.float32(1.0 / (gmax - gmin))))
        if tg is None:
            return None
    return ti, tg


def _block_max_u8(a: torch.Tensor, map_shape_zyx) -> torch.Tensor:
    """Per-block u8 max over (bz, by, bx) blocks, zero-padded (0 is neutral
    for max)."""
    mz, my, mx = map_shape_zyx
    d, h, w = a.shape
    bz, by, bx = (-(-d // mz), -(-h // my), -(-w // mx))
    a = torch.nn.functional.pad(
        a, (0, mx * bx - w, 0, my * by - h, 0, mz * bz - d))
    a = a.reshape(mz, bz, my * by, mx * bx).amax(dim=1)
    a = a.reshape(mz, my, by, mx * bx).amax(dim=2)
    return a.reshape(mz, my, mx, bx).amax(dim=3)


def _occupancy_u8(volume_u8: torch.Tensor, gradient_u8: torch.Tensor | None,
                  map_shape_zyx, ti: int, tg: int) -> torch.Tensor:
    """u8 occupancy map, OCCUPIED = 0 / EMPTY = 255 (threshold 256 = "no u8
    value is positive")."""
    if ti > 255 or tg > 255:
        return torch.full(map_shape_zyx, EMPTY, dtype=torch.uint8,
                          device=volume_u8.device)
    if gradient_u8 is None:
        occ = _block_max_u8(volume_u8, map_shape_zyx) >= ti
    else:
        mask = ((volume_u8 >= ti) & (gradient_u8 >= tg)).to(torch.uint8)
        occ = _block_max_u8(mask, map_shape_zyx) >= 1
    return torch.where(occ, OCCUPIED, EMPTY).to(torch.uint8)


def _count_u8(volume_u8: torch.Tensor, gradient_u8: torch.Tensor | None,
              ti: int, tg: int) -> int:
    """Number of voxels with alpha > 0 (one host read)."""
    if ti > 255 or tg > 255:
        return 0
    occ = volume_u8 >= ti
    if gradient_u8 is not None:
        occ &= gradient_u8 >= tg
    return int(occ.sum(dtype=torch.int64))


def occupied_voxel_count(volume_u8: torch.Tensor,
                         gradient_u8: torch.Tensor | None, tf,
                         tf_host) -> int:
    """Total number of voxels with TF alpha > 0, printed by the reference as
    ``Occupied voxels: X%`` (src/volume_render.cpp:399-418)."""
    thr = _tf_thresholds(tf_host)
    if thr is None:
        raise NotImplementedError(
            "non-monotone TF ranges (general float occupancy path): "
            "ROADMAP queue A, item 5")
    ti, tg = thr
    return _count_u8(volume_u8, gradient_u8 if tf.use_gradient else None,
                     ti, tg)
