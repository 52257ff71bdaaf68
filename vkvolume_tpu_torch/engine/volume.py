"""Volume state — port of ``vkvolume_tpu/engine/volume.py`` (the reference's
``Volume`` scene component, src/volume_component.h:31-93): the density and
its acceleration maps are tensors on the volume's device, the transforms
are host numpy. Loading from files (``from_file``, ``io/``) is not ported
yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel import occupancy as occ_mod
from ..options import VolumeOptions
from ..utils import math3d


@dataclasses.dataclass
class Volume:
    name: str
    density: torch.Tensor              # (D, H, W) uint8
    options: VolumeOptions
    image_transform: np.ndarray        # (4,4)
    node_transform: np.ndarray = dataclasses.field(
        default_factory=math3d.identity
    )
    block_size: int = 4                # nominal distance-map block size
    gradient: torch.Tensor | None = None    # (D, H, W) uint8
    dist_maps: torch.Tensor | None = None   # (N, mz, my, mx) uint8; N=1 or 8

    @property
    def device(self) -> torch.device:
        return self.density.device

    @property
    def extent_xyz(self) -> tuple[int, int, int]:
        d, h, w = self.density.shape
        return (w, h, d)

    @property
    def map_shape_zyx(self) -> tuple[int, int, int]:
        """Occupancy/distance-map shape = ceil(extent / block_size)
        (src/volume_component.cpp:91-92)."""
        d, h, w = self.density.shape
        b = self.block_size
        return (-(-d // b), -(-h // b), -(-w // b))

    @property
    def effective_block_size_xyz(self) -> tuple[int, int, int]:
        mz, my, mx = self.map_shape_zyx
        return occ_mod.effective_block_size(self.extent_xyz, (mx, my, mz))

    @property
    def model_matrix(self) -> np.ndarray:
        """node_transform @ image_transform (src/volume_render_subpass.cpp:227)."""
        return self.node_transform.astype(np.float64) @ self.image_transform.astype(
            np.float64
        )

    def set_scale(self, scale_xyz) -> None:
        """Node scale (src/volume_render.cpp:233-237)."""
        self.node_transform = math3d.scale(scale_xyz)


def from_array(
    data: np.ndarray,
    options: VolumeOptions | None = None,
    block_size: int = 4,
    voxel_size=(1.0, 1.0, 1.0),
    name: str = "volume",
    device: str | torch.device = "cpu",
) -> Volume:
    """Volume from a (D, H, W) uint8 array, copied to ``device``."""
    d, h, w = data.shape
    physical = np.asarray(voxel_size, np.float32) * np.asarray([w, h, d], np.float32)
    return Volume(
        name=name,
        density=torch.tensor(data, dtype=torch.uint8, device=device),
        options=options or VolumeOptions(),
        image_transform=math3d.scale(physical),
        block_size=block_size,
    )
