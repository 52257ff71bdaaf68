"""Volume state — port of ``vkvolume_tpu/engine/volume.py`` (the reference's
``Volume`` scene component, src/volume_component.h:31-93): the density and
its acceleration maps are tensors on the volume's device, the transforms
are host numpy, and so is the baked TF texture (``tf_texture``, rebaked on
every TF edit), whose device copy ``texture_on_device`` caches per bake.
``from_file`` loads a raw volume with its ``.header``
sidecar (``io/``); ``set_spin`` is the reference's spin animation and
``get_translation`` / ``set_translation`` its per-volume XYZ drag.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel import occupancy as occ_mod
from ..io.header import Header
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
    tf_texture: np.ndarray | None = None    # (256, 256, 4) uint8 baked TF
    dist_maps: torch.Tensor | None = None   # (N, mz, my, mx) uint8; N=1 or 8
    header: Header | None = None

    @property
    def device(self) -> torch.device:
        return self.density.device

    def texture_on_device(self) -> torch.Tensor:
        """``tf_texture`` on the volume's device, copied once per bake."""
        cached = getattr(self, "_tf_texture_dev", None)
        if cached is None or cached[0] is not self.tf_texture:
            if self.tf_texture is None:
                raise ValueError("no baked TF texture (the engine bakes it "
                                 "in update_transfer_function)")
            cached = self._tf_texture_dev = (
                self.tf_texture,
                torch.as_tensor(np.ascontiguousarray(self.tf_texture,
                                                     np.uint8),
                                device=self.device))
        return cached[1]

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
        self._spin_base = None

    def get_translation(self) -> np.ndarray:
        """The node's translation (the reference GUI reads it back for the
        per-volume XYZ drag, src/volume_render.cpp:464)."""
        return np.asarray(self.node_transform, np.float64)[:3, 3].copy()

    def set_translation(self, xyz) -> None:
        """Replace the node's translation, keeping its rotation and scale
        (src/volume_render.cpp:464-468), and retarget the captured spin
        base, so that a spinning volume keeps turning about its new
        position."""
        t = np.asarray(xyz, np.float64)
        m = np.asarray(self.node_transform, np.float64).copy()
        m[:3, 3] = t
        self.node_transform = m.astype(np.float32)
        base = getattr(self, "_spin_base", None)
        if base is not None:
            base = np.asarray(base, np.float64).copy()
            base[:3, 3] = t
            self._spin_base = base

    def set_spin(self, angle_rad: float, axis=(0.0, 1.0, 0.0)) -> None:
        """Node rotation by an absolute angle over the node's spin-free
        transform, captured on first use — the reference's ``spin_volumes``
        animation (src/volume_render.cpp:89, :256-271). The rotation is
        about the node's own position: T · R · linear(base)."""
        base = getattr(self, "_spin_base", None)
        if base is None:
            base = self._spin_base = np.asarray(self.node_transform,
                                                np.float64)
        lin = np.asarray(base, np.float64).copy()
        t = lin[:3, 3].copy()
        lin[:3, 3] = 0.0
        m = math3d.rotate(angle_rad, axis).astype(np.float64) @ lin
        m[:3, 3] = t
        self.node_transform = m.astype(np.float32)


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a torch.device, a CUDA one with its index; raises when
    it names CUDA and no CUDA device is available (nothing falls back to
    the CPU: pass device="cpu" for the plain PyTorch versions)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r}: no CUDA device is available "
                "(device='cpu' runs the plain PyTorch versions)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def from_file(path: str, options: VolumeOptions | None = None,
              block_size: int = 4, name: str | None = None,
              device: str | torch.device = "cuda") -> Volume:
    """Load and normalise a volume from ``<path>`` / ``<path>.header``
    onto ``device`` (``Volume::load_from_file``,
    src/volume_component.cpp:55-153); the default, the CUDA card, raises
    without one."""
    from ..io.loader import load_volume

    device = resolve_device(device)
    data, header = load_volume(path)
    return Volume(
        name=name or str(path),
        density=torch.from_numpy(np.ascontiguousarray(data)).to(device),
        options=options or VolumeOptions(),
        image_transform=header.image_transform,
        block_size=block_size,
        header=header,
    )


def from_array(
    data: np.ndarray,
    options: VolumeOptions | None = None,
    block_size: int = 4,
    voxel_size=(1.0, 1.0, 1.0),
    name: str = "volume",
    device: str | torch.device = "cuda",
) -> Volume:
    """Volume from a (D, H, W) uint8 array, copied to ``device`` (by
    default the CUDA card; raises without one)."""
    device = resolve_device(device)
    d, h, w = data.shape
    physical = np.asarray(voxel_size, np.float32) * np.asarray([w, h, d], np.float32)
    return Volume(
        name=name,
        density=torch.tensor(data, dtype=torch.uint8, device=device),
        options=options or VolumeOptions(),
        image_transform=math3d.scale(physical),
        block_size=block_size,
    )
