"""The w-grid frame's glue around K1 and K2 on the card — three launches of
``csrc/frame_glue.cu``, computed from the pose's scalars passed by value:

* ``frame_grid``: the w-grid fields K1 reads, (wu, wv, s_lo, s_hi, kappa,
  cov);
* ``frame_positions``: the warp's positions (``Positions``) of the
  image's own pixel rays;
* ``frame_epilogue``: the (3, Hi, Wi) channel stack [lum, alpha, depth]
  from K1's outputs.

The JAX package leaves this glue to XLA, so the kernels mirror no Pallas
kernel. These launchers take CUDA devices only, or raise; the frame calls
them through ``sweep_frame``'s functions of the same names, which run the
plain twins beside them there (``grid_plain``, ``positions_plain``,
``epilogue_plain``) on CPU tensors. ``LAUNCHES`` counts their launches,
one of each per K1 frame on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils import cuda_build, timing
from .ray_setup import N_PACKED

LAUNCHES = {"frame_grid": 0, "frame_positions": 0, "frame_epilogue": 0}
# The warps whose positions ``frame_positions`` writes: the two-pass warp's
# variants and the single-pass warp (K8, whose (gx, gy) the gather warp
# reads too); the index is the kernel's.
WARPS = ("A", "B", "K8")


@dataclasses.dataclass(frozen=True)
class FrameGeometry:
    """What one frame's glue is computed from: ``packed``, the pose's
    ``pack_frame_scalars`` array, and the plan's integers: the slice axis,
    the sweep's sign (+-1), the grid's ``Hi`` rows from ``row0`` (a
    shard's first row) and ``Wi`` columns, the ``height`` x ``width``
    image, the ``warp`` (``WARPS``) and, for kappa, the volume's largest
    extent and the slab count."""
    packed: np.ndarray
    p_axis: int
    sgn: int
    Hi: int
    Wi: int
    height: int
    width: int
    warp: str
    dim_max: int
    n_slabs: int
    row0: int = 0

    @property
    def Hp(self) -> int:
        """The image's rows padded to 128 (the two-pass warp's lines)."""
        return -(-self.height // 128) * 128

    @functools.cached_property
    def scalars(self) -> cuda_build.FrameScalars:
        """The kernels' launch struct, built once (raises on what they do
        not take)."""
        packed = np.ascontiguousarray(self.packed, np.float32)
        if packed.shape != (N_PACKED,):
            raise ValueError(f"packed: expected ({N_PACKED},), "
                             f"got {packed.shape}")
        if self.p_axis not in (0, 1, 2) or self.sgn not in (1, -1):
            raise ValueError(f"p_axis {self.p_axis} / sgn {self.sgn}: "
                             "expected 0-2 / +-1")
        if self.warp not in WARPS:
            raise ValueError(f"warp {self.warp!r}: expected one of {WARPS}")
        if min(self.Hi, self.Wi, self.height, self.width) <= 0 \
                or self.Hi > 65535 or self.row0 < 0:
            raise ValueError(f"grid {self.Hi}x{self.Wi} from row "
                             f"{self.row0}, image {self.height}x"
                             f"{self.width}")
        f32 = np.float32
        return cuda_build.FrameScalars(
            (ctypes.c_float * packed.size).from_buffer_copy(packed),
            self.Hi, self.Wi, self.row0, self.height, self.width, self.Hp,
            self.p_axis, self.sgn, WARPS.index(self.warp),
            float(f32(self.dim_max) / f32(self.n_slabs)))


class Positions(NamedTuple):
    """The warp's positions: ``gx`` (H, W), each pixel's grid column (-10
    where its ray misses; the pixel stage's coverage), and per warp: "A"
    ``pos1`` = xa (Hi, W), ``pos2`` = gy_t (W, Hp); "B" ``pos1`` = yb
    (Wi, Hp), ``pos2`` = gx_p (Hp, W); "K8" ``gy`` (H, W). The others are
    None."""
    gx: torch.Tensor
    gy: torch.Tensor | None
    pos1: torch.Tensor | None
    pos2: torch.Tensor | None


def _require_device(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"device: expected a CUDA device, got {device}")
    return device


def frame_grid(geom: FrameGeometry, device) -> tuple:
    """The grid fields on a CUDA ``device``, one launch: five float32 maps
    and the bool coverage."""
    device = _require_device(device)
    scalars = geom.scalars
    shape = (geom.Hi, geom.Wi)
    out = [torch.empty(shape, dtype=torch.float32, device=device)
           for _ in range(5)]
    cov = torch.empty(shape, dtype=torch.bool, device=device)
    with timing.kernel(LAUNCHES, "frame_grid"):
        cuda_build.check(cuda_build.load_kernels().vkv_frame_grid(
            *(t.data_ptr() for t in out), cov.data_ptr(), scalars,
            cuda_build.stream()), "frame_grid")
    return (*out, cov)


def frame_positions(geom: FrameGeometry, device) -> Positions:
    """The warp's positions on a CUDA ``device``, one launch."""
    device = _require_device(device)
    scalars = geom.scalars
    H, W, Hp = geom.height, geom.width, geom.Hp

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    if geom.warp == "A":
        pos = Positions(empty(H, W), None, empty(geom.Hi, W), empty(W, Hp))
    elif geom.warp == "B":
        gx_p = empty(Hp, W)
        pos = Positions(gx_p[:H], None, empty(geom.Wi, Hp), gx_p)
    else:
        pos = Positions(empty(H, W), empty(H, W), None, None)
    ptrs = [None if t is None else t.data_ptr() for t in pos]
    with timing.kernel(LAUNCHES, "frame_positions"):
        cuda_build.check(cuda_build.load_kernels().vkv_frame_positions(
            *ptrs, scalars, cuda_build.stream()), "frame_positions")
    return pos


def frame_epilogue(geom: FrameGeometry, lum: torch.Tensor,
                   alpha: torch.Tensor, firsts: torch.Tensor) -> torch.Tensor:
    """The channel stack from CUDA maps, one launch."""
    shape = (geom.Hi, geom.Wi)
    for name, t in (("lum", lum), ("alpha", alpha), ("firsts", firsts)):
        cuda_build.require_cuda(name, t, torch.float32, shape)
        cuda_build.require_aligned(name, t, 4)
        if t.device != lum.device:
            raise ValueError(f"{name}: expected lum's device, got "
                             f"{t.device}")
    scalars = geom.scalars
    chans = torch.empty((3,) + shape, dtype=torch.float32, device=lum.device)
    with timing.kernel(LAUNCHES, "frame_epilogue"):
        cuda_build.check(cuda_build.load_kernels().vkv_frame_epilogue(
            lum.data_ptr(), alpha.data_ptr(), firsts.data_ptr(),
            chans.data_ptr(), scalars, cuda_build.stream()),
            "frame_epilogue")
    return chans
