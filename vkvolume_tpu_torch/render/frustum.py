"""Rays of the w-grid — port of ``rays_from_dirs`` in
``vkvolume_tpu/render/frustum.py``.

A w-grid cell's ray leaves the camera along ``dir ∝ (w_u, w_v, 1)`` in
(u, v, p) texture axes. The per-slab sweep (K7) reads each cell's ray
interval: the entry and exit points and coverage, from the same interval
arithmetic as ``make_rays`` (AABB slab test and clip-plane entry clamp,
which replace the reference's rasterised draws).
"""

from __future__ import annotations

import numpy as np
import torch

from .ray_setup import FrameUniforms, RaySetup, ray_caster_get_back


def rays_from_dirs(u: FrameUniforms, dirs: torch.Tensor) -> RaySetup:
    """Entry / exit / coverage of rays from the camera along ``dirs``
    ((H, W, 3) normalised texture-space directions), on their device."""
    dev = dirs.device
    m = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    H, W = dirs.shape[:2]
    o = m(u.cam_pos_tex)
    d = dirs
    dir_inv = 1.0 / d
    t0 = (0.0 - o) * dir_inv
    t1 = (1.0 - o) * dir_inv
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    plane = m(u.plane_tex)
    s_o = torch.dot(plane[:3], o) + plane[3]
    s_d = d @ plane[:3]
    t_plane = torch.where(s_d != 0.0, -s_o / s_d,
                          torch.tensor(float("inf"), device=dev))
    t_entry = torch.where(s_d > 0.0, torch.maximum(t_near, t_plane), t_near)
    valid = (t_entry < t_far) & (t_far > 0.0)
    entry = o + t_entry[..., None] * d
    exit_ = ray_caster_get_back(entry, d)
    return RaySetup(
        ray_dir=d, valid=valid,
        depth_init=torch.zeros((H, W), dtype=torch.float32, device=dev),
        entry=entry, exit=exit_)
