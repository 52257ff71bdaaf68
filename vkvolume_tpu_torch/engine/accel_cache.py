"""Acceleration-map cache — port of ``vkvolume_tpu/engine/accel_cache.py``.

Saves a volume's gradient and occupancy / distance maps to
``<cache_dir>/<key>.npz`` and restores them, keyed on the volume's name
and shape, a strided probe of its voxels, its block size, the skipping
type, the TF slider values and the gradient mode. The key and the file
layout are the JAX package's, so a cache written by either package loads
in the other.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch


def _key(volume, skipping_type) -> str:
    o = volume.options
    d, h, w = volume.density.shape
    # A probe of every 64th voxel along each axis: one small device-to-host
    # copy, where hashing the whole volume would cost what the cache saves.
    probe = volume.density[::64, ::64, ::64].cpu().numpy().tobytes()
    raw = (
        f"{volume.name}|{d}x{h}x{w}|bs{volume.block_size}|st{int(skipping_type)}|"
        f"tf{o.intensity_min:.6g},{o.intensity_max:.6g},{o.gradient_min:.6g},"
        f"{o.gradient_max:.6g}|g{int(o.use_precomputed_gradient)}"
    ).encode() + hashlib.sha1(probe).digest()
    return hashlib.sha1(raw).hexdigest()


def save(cache_dir: str, volume, skipping_type) -> str:
    """Write the volume's maps; returns the file's path."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, _key(volume, skipping_type) + ".npz")
    arrays = {}
    if volume.gradient is not None:
        arrays["gradient"] = volume.gradient.cpu().numpy()
    if volume.dist_maps is not None:
        arrays["dist_maps"] = volume.dist_maps.cpu().numpy()
    np.savez_compressed(path, **arrays)
    return path


def load(cache_dir: str, volume, skipping_type) -> bool:
    """Restore the maps of this (volume, TF, skipping type) onto the
    volume's device; False when the cache holds none."""
    path = os.path.join(cache_dir, _key(volume, skipping_type) + ".npz")
    if not os.path.exists(path):
        return False
    with np.load(path) as z:
        if "gradient" in z:
            volume.gradient = torch.from_numpy(z["gradient"]).to(
                volume.device)
        if "dist_maps" in z:
            volume.dist_maps = torch.from_numpy(z["dist_maps"]).to(
                volume.device)
    return True
