"""Gradient-magnitude map — the 4-tap tetrahedron stencil, plain PyTorch.

Port of ``vkvolume_tpu/accel/gradient.py`` (shaders/gradient_map.comp +
get_gradient_compute.glsl:5-23): per voxel

    dir = 0.25 * sum_k k * v[p + k]   over the taps k of a tetrahedron
    g   = clamp(|dir| * grad_magnitude_modifier, 0, 1)   stored as R8 unorm

with taps clamped to the volume bounds.
"""

from __future__ import annotations

import torch

# Tetrahedron tap offsets in (x, y, z) (get_gradient_compute.glsl:13-18).
_TAPS = ((1, -1, -1), (-1, -1, 1), (-1, 1, -1), (1, 1, 1))


def gradient_map(volume_u8: torch.Tensor,
                 grad_magnitude_modifier: float = 1.0, *,
                 use_gradient: bool = True) -> torch.Tensor:
    """R8-unorm gradient map of a (D, H, W) u8 volume, on its device. With
    ``use_gradient`` False the reference writes 1.0 everywhere
    (get_gradient_compute.glsl:6-7)."""
    if not use_gradient:
        return torch.full(volume_u8.shape, 255, dtype=torch.uint8,
                          device=volume_u8.device)
    d, h, w = volume_u8.shape
    # Edge padding = clamped taps.
    padded = torch.nn.functional.pad(
        volume_u8.to(torch.float32)[None, None], (1, 1, 1, 1, 1, 1),
        mode="replicate")[0, 0].to(torch.int32)
    acc = [torch.zeros((d, h, w), dtype=torch.int32, device=volume_u8.device)
           for _ in range(3)]
    for ox, oy, oz in _TAPS:
        v = padded[1 + oz:1 + oz + d, 1 + oy:1 + oy + h, 1 + ox:1 + ox + w]
        for a, o in zip(acc, (ox, oy, oz)):
            a += o * v
    # The sum of squares is an exact integer (< 2^24). Its square root is
    # taken in float64 and rounded to float32 — the correctly rounded
    # float32 root that XLA computes (PyTorch's vectorised float32 sqrt on
    # the CPU is not correctly rounded for every input).
    sumsq = sum(a * a for a in acc)
    mag = torch.sqrt(sumsq.to(torch.float64)).to(torch.float32) \
        * (0.25 / 255.0)
    g = (mag * grad_magnitude_modifier).clamp(0.0, 1.0)
    return torch.round(g * 255.0).to(torch.uint8)
