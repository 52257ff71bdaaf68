"""Occupancy map and occupied-voxel count — block reductions in plain
PyTorch, port of ``vkvolume_tpu/accel/occupancy.py``
(shaders/occupancy_map.comp:45-73, occupied_voxel_count.comp).

Fast path: the closed-form ``alpha > 0`` test is monotone in the u8
intensity (and gradient), so "any voxel of the block has alpha > 0" is a
per-block u8 max compared with a threshold that the host derives with the
device's exact float32 arithmetic; on the card it is one kernel launch
(``occupancy_cuda``, ``csrc/occupancy.cu``). General path (a TF range
that is not monotone, e.g. ``imin > imax``): the per-voxel float32 test
``voxel_alpha_positive``, reduced per block as a u8 mask. Either path takes
the gradient map or, with ``on_the_fly_gradient``, computes it from the
volume (``accel/gradient.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import occupancy_cuda
from .gradient import gradient_map

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


_INV255 = float(np.float32(1.0 / 255.0))


def voxel_alpha_positive(volume_u8: torch.Tensor,
                         gradient_u8: torch.Tensor | None,
                         tf) -> torch.Tensor:
    """Per-voxel ``get_color(intensity, gradient).a > 0``, a bool tensor
    (occupancy_map.comp:61-64 with the closed-form TF,
    transfer_function.glsl:40-43): alpha > 0 iff alpha_i > 0 and
    alpha_g > 0. ``gradient_u8=None`` with a gradient TF computes the
    gradient map on the fly (get_gradient_compute.glsl:12-20).

    Each float32 operation is its own op (convert, multiply, subtract,
    multiply, clip), rounded on its own as in the JAX package; one float
    temporary of the volume's size is live at a time."""
    def positive(u8, lo, inv):
        a = u8.to(torch.float32)
        a.mul_(_INV255)
        a.sub_(lo)
        a.mul_(inv)
        a.clamp_(0.0, 1.0)
        return a > 0.0

    occ = positive(volume_u8, tf.intensity_min, tf.intensity_range_inv)
    if not tf.use_gradient:
        return occ
    return occ & positive(_gradient_of(volume_u8, gradient_u8, tf),
                          tf.gradient_min, tf.gradient_range_inv)


def _tf_thresholds(tf, tf_host=None):
    """(ti, tg) u8 thresholds for the integer path, or None when a range is
    not monotone. ``tf_host = (imin, imax, gmin, gmax)``: the host slider
    values, with the TF's float32 derivation (tf_params); without it the
    TF's own float32 fields."""
    if tf_host is not None:
        imin, imax, gmin, gmax = tf_host
        lo_i, inv_i = (float(np.float32(imin)),
                       float(np.float32(1.0 / (imax - imin))))
        use_gradient = gmax != gmin
        if use_gradient:
            lo_g, inv_g = (float(np.float32(gmin)),
                           float(np.float32(1.0 / (gmax - gmin))))
    else:
        lo_i, inv_i = tf.intensity_min, tf.intensity_range_inv
        use_gradient = tf.use_gradient
        lo_g, inv_g = tf.gradient_min, tf.gradient_range_inv
    ti = alpha_positive_threshold(lo_i, inv_i)
    if ti is None:
        return None
    tg = 0
    if use_gradient:
        tg = alpha_positive_threshold(lo_g, inv_g)
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
    value is positive"): the plain version for a CPU tensor, else one
    launch of the kernel (``occupancy_cuda``)."""
    if ti > 255 or tg > 255:
        return torch.full(map_shape_zyx, EMPTY, dtype=torch.uint8,
                          device=volume_u8.device)
    if volume_u8.device.type == "cpu":
        return _occupancy_u8_plain(volume_u8, gradient_u8, map_shape_zyx, ti,
                                   tg)
    return occupancy_cuda.occupancy_u8(volume_u8, gradient_u8, map_shape_zyx,
                                       ti, tg)


def _occupancy_u8_plain(volume_u8: torch.Tensor,
                        gradient_u8: torch.Tensor | None, map_shape_zyx,
                        ti: int, tg: int) -> torch.Tensor:
    """The integer path in plain PyTorch, thresholds in [0, 255] (the
    kernel's twin): the per-block max of the volume, or of the u8 mask of
    both tests, against its threshold."""
    if gradient_u8 is None:
        occ = _block_max_u8(volume_u8, map_shape_zyx) >= ti
    else:
        mask = ((volume_u8 >= ti) & (gradient_u8 >= tg)).to(torch.uint8)
        occ = _block_max_u8(mask, map_shape_zyx) >= 1
    return torch.where(occ, OCCUPIED, EMPTY).to(torch.uint8)


def _occupancy_general(volume_u8: torch.Tensor,
                       gradient_u8: torch.Tensor | None, tf,
                       map_shape_zyx) -> torch.Tensor:
    """The float path (non-monotone TF ranges): the per-voxel test, then
    the per-block max of its u8 mask."""
    mask = voxel_alpha_positive(volume_u8, gradient_u8, tf).to(torch.uint8)
    occ = _block_max_u8(mask, map_shape_zyx) >= 1
    return torch.where(occ, OCCUPIED, EMPTY).to(torch.uint8)


def _gradient_of(volume_u8: torch.Tensor, gradient_u8: torch.Tensor | None,
                 tf) -> torch.Tensor | None:
    """The gradient map both paths read: None without a gradient TF, else
    ``gradient_u8``, or computed from the volume when it is None."""
    if not tf.use_gradient:
        return None
    if gradient_u8 is None:
        return gradient_map(volume_u8, tf.grad_magnitude_modifier,
                            use_gradient=True)
    return gradient_u8


def _occupancy(volume_u8: torch.Tensor, gradient_u8: torch.Tensor | None,
               tf, map_shape_zyx, thr) -> torch.Tensor:
    """The map by the integer path with thresholds ``thr``
    (``_tf_thresholds``), or by the float path when ``thr`` is None;
    ``gradient_u8=None`` with a gradient TF: gradients on the fly."""
    gradient_u8 = _gradient_of(volume_u8, gradient_u8, tf)
    if thr is None:
        return _occupancy_general(volume_u8, gradient_u8, tf, map_shape_zyx)
    return _occupancy_u8(volume_u8, gradient_u8, map_shape_zyx, *thr)


def occupancy_map(volume_u8: torch.Tensor, gradient_u8: torch.Tensor | None,
                  tf, map_shape_zyx, on_the_fly_gradient: bool = False,
                  tf_host=None) -> torch.Tensor:
    """u8 occupancy map of shape ``map_shape_zyx``: OCCUPIED = 0 /
    EMPTY = 255. The integer path when the TF's ranges are monotone, else
    the float path; ``on_the_fly_gradient`` (or no gradient map with a
    gradient TF) computes the gradients from the volume."""
    return _occupancy(volume_u8, None if on_the_fly_gradient else gradient_u8,
                      tf, map_shape_zyx, _tf_thresholds(tf, tf_host))


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
                         on_the_fly_gradient: bool = False,
                         tf_host=None) -> int:
    """Total number of voxels with TF alpha > 0, printed by the reference as
    ``Occupied voxels: X%`` (src/volume_render.cpp:399-418), by the same
    two paths as ``occupancy_map``. An exact Python int on both paths; the
    JAX package's float path sums in int32 unless x64 is on, so the two
    agree below 2**31 voxels (the 1024³ kingsnake has 833 M)."""
    gradient_u8 = _gradient_of(
        volume_u8, None if on_the_fly_gradient else gradient_u8, tf)
    thr = _tf_thresholds(tf, tf_host)
    if thr is None:
        return int(voxel_alpha_positive(volume_u8, gradient_u8, tf)
                   .sum(dtype=torch.int64))
    return _count_u8(volume_u8, gradient_u8, *thr)
