"""Carry the JAX package's state into the port's objects.

Every function takes host numpy arrays and Python floats (never jax
arrays): a caller that holds JAX state converts it with ``np.asarray``
first. Used by the tests to feed JAX-built maps, TF parameters, baked TF
textures, uniforms and ray setups into the port, so that each stage is
compared on identical inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .engine.volume import Volume, from_array
from .io.header import Header
from .options import VolumeOptions
from .render.ray_setup import FrameUniforms, RaySetup
from .tf.transfer_function import TFParams


def volume_from_numpy(density: np.ndarray, image_transform: np.ndarray,
                      node_transform: np.ndarray, block_size: int,
                      options: VolumeOptions | None = None,
                      device: str | torch.device = "cpu",
                      gradient: np.ndarray | None = None,
                      header: Header | None = None) -> Volume:
    """A port Volume with the given (D, H, W) u8 density and transforms,
    and optionally its (D, H, W) u8 gradient map and file header."""
    vol = from_array(np.asarray(density, np.uint8), options,
                     block_size=block_size, device=device)
    vol.image_transform = np.asarray(image_transform, np.float32)
    vol.node_transform = np.asarray(node_transform, np.float32)
    if gradient is not None:
        vol.gradient = torch.tensor(np.asarray(gradient, np.uint8),
                                    device=device)
    vol.header = header
    return vol


def tf_from_numpy(fields: dict) -> TFParams:
    """TFParams from a dict of its fields (scalars or 0-d arrays)."""
    kw = {}
    for f in dataclasses.fields(TFParams):
        if f.name not in fields:
            continue
        v = fields[f.name]
        kw[f.name] = (bool(v) if f.name == "use_gradient"
                      else float(np.float32(np.asarray(v))))
    return TFParams(**kw)


def uniforms_from_numpy(fields: dict) -> FrameUniforms:
    """FrameUniforms from a dict of its fields (arrays of any float type)."""
    kw = {f.name: np.asarray(fields[f.name], np.float32)
          for f in dataclasses.fields(FrameUniforms)
          if f.name != "front_index"}
    kw["front_index"] = np.int32(np.asarray(fields["front_index"]))
    return FrameUniforms(**kw)


def texture_from_numpy(tex: np.ndarray,
                       device: str | torch.device = "cpu") -> torch.Tensor:
    """A baked (256, 256, 4) u8 TF texture as a tensor on ``device``."""
    tex = np.asarray(tex, np.uint8)
    if tex.shape != (256, 256, 4):
        raise ValueError(f"TF texture of shape {tex.shape}")
    return torch.tensor(tex, device=device)


def rays_from_numpy(fields: dict,
                    device: str | torch.device = "cpu") -> RaySetup:
    """RaySetup from a dict of its fields (arrays; ``valid`` as bool, the
    rest float32). Fields the dict lacks stay None."""
    kw = {}
    for f in dataclasses.fields(RaySetup):
        if fields.get(f.name) is None:
            continue
        a = np.asarray(fields[f.name])
        kw[f.name] = torch.tensor(
            a.astype(bool) if f.name == "valid" else a.astype(np.float32),
            device=device)
    return RaySetup(**kw)


def maps_from_numpy(maps_u8: np.ndarray,
                    device: str | torch.device = "cpu") -> torch.Tensor:
    """Distance / occupancy maps as a contiguous u8 tensor on ``device``."""
    return torch.tensor(np.asarray(maps_u8, np.uint8), device=device)
