"""Texture sampling — port of ``vkvolume_tpu/render/sampling.py``: trilinear
volume reads, distance-map texel fetches and on-the-fly gradients as
gathers from flat device tensors, with the reference sampler's
conventions (``texture(volume, pos)`` with a linear CLAMP_TO_EDGE sampler,
``texelFetch(distance_map, u_i, 0)``; shaders/volume_render.frag:272,
230-232):

* texel centres at ``(i + 0.5) / dim``: sample position ``p = u*dim - 0.5``;
* CLAMP_TO_EDGE: corner indices clamped to ``[0, dim-1]``;
* R8 unorm: value = u8 / 255.

Arrays are ``(D, H, W)`` (z-major); positions are ``(x, y, z)`` like
GLSL. Flat indices are int64: the full-scale snake has 834 M voxels, and
``torch`` indexes with int64 anyway.
"""

from __future__ import annotations

import numpy as np
import torch

_INV255 = float(np.float32(1.0 / 255.0))
# The on-the-fly gradient's four tap directions (volume_render.frag:91-97).
_TAPS = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0),
         (1.0, 1.0, 1.0))


def trilinear(volume_u8: torch.Tensor, pos_xyz: torch.Tensor,
              global_depth: int | None = None,
              origin_z: int | torch.Tensor | None = None) -> torch.Tensor:
    """``texture(volume, pos).x``: the trilinear unorm sample in [0, 1] of
    ``pos_xyz`` (..., 3) texture coordinates.

    Volume-sharded mode: ``volume_u8`` is a z-slab of a
    ``global_depth``-deep volume whose first plane is global plane
    ``origin_z``. Coordinates and CLAMP_TO_EDGE use the global depth; the
    taps are then rebased into the slab and clamped to its edge (callers
    clamp rays to the slab, so only masked lanes reach past it)."""
    d, h, w = volume_u8.shape
    D = d if global_depth is None else global_depth
    f = torch.float32
    dims = torch.tensor([w, h, D], dtype=f, device=pos_xyz.device)
    p = pos_xyz * dims - 0.5
    i0f = torch.floor(p)
    frac = p - i0f
    i0 = i0f.to(torch.int64)
    hi = torch.tensor([w - 1, h - 1, D - 1], dtype=torch.int64,
                      device=pos_xyz.device)
    i1 = torch.minimum(torch.clamp(i0 + 1, min=0), hi)
    i0 = torch.minimum(torch.clamp(i0, min=0), hi)
    z = torch.stack([i0[..., 2], i1[..., 2]], -1)
    if origin_z is not None:
        z = (z - origin_z).clamp(0, d - 1)
    y = torch.stack([i0[..., 1], i1[..., 1]], -1)
    x = torch.stack([i0[..., 0], i1[..., 0]], -1)
    # (..., 2, 2, 2) taps [z][y][x], one gather.
    idx = ((z[..., :, None, None] * h + y[..., None, :, None]) * w
           + x[..., None, None, :])
    c = volume_u8.reshape(-1)[idx].to(f)
    fx, fy, fz = frac[..., 0:1], frac[..., 1:2], frac[..., 2]
    cx = c[..., 0] + (c[..., 1] - c[..., 0]) * fx[..., None]   # (..., 2, 2)
    cy = cx[..., 0] + (cx[..., 1] - cx[..., 0]) * fy            # (..., 2)
    return (cy[..., 0] + (cy[..., 1] - cy[..., 0]) * fz) * _INV255


def texel_fetch(map_u8: torch.Tensor, u_i_xyz: torch.Tensor) -> torch.Tensor:
    """``texelFetch(map, u_i, 0).x``: the integer texel read (indices
    clamped by the caller)."""
    d, h, w = map_u8.shape
    u = u_i_xyz.to(torch.int64)
    idx = (u[..., 2] * h + u[..., 1]) * w + u[..., 0]
    return map_u8.reshape(-1)[idx]


def gradient_on_the_fly(volume_u8: torch.Tensor, pos_xyz: torch.Tensor,
                        grad_magnitude_modifier: float,
                        global_depth: int | None = None,
                        origin_z: int | torch.Tensor | None = None
                        ) -> torch.Tensor:
    """The fragment shader's on-the-fly gradient: four linear taps at
    ``pos + dim_inv * k`` (shaders/volume_render.frag:91-97)."""
    d, h, w = volume_u8.shape
    D = d if global_depth is None else global_depth
    f32 = np.float32
    dim_inv = torch.tensor([f32(1.0) / f32(w), f32(1.0) / f32(h),
                            f32(1.0) / f32(D)], dtype=torch.float32,
                           device=pos_xyz.device)
    acc = torch.zeros(pos_xyz.shape, dtype=torch.float32,
                      device=pos_xyz.device)
    for k in _TAPS:
        tap = torch.tensor(k, dtype=torch.float32, device=pos_xyz.device)
        v = trilinear(volume_u8, pos_xyz + dim_inv * tap,
                      global_depth=global_depth, origin_z=origin_z)
        acc = acc + tap * v[..., None]
    a = acc * 0.25
    g = torch.sqrt(a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]
                   + a[..., 2] * a[..., 2]) * grad_magnitude_modifier
    return g.clamp(0.0, 1.0)
