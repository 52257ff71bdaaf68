"""Sidecar ``.header`` parser — byte-compatible with the reference grammar.

The JAX package's ``vkvolume_tpu/io/header.py``, unchanged: host numpy
(and ctypes) only, shared by both packages' file formats.

The reference parses a 5-line text header (reference: src/load_volume.cpp:33-86,
grammar documented in README.md:58-68)::

    832 832 494 # extents
    0.001 0.001 0.001 # voxel size
    400.0 2538.0 # normalisation range
    uint16_t little # data type and endianness (big or little)
    1 0 0 90 # rotation axis and angle (degrees)

Trailing ``# comments`` are tolerated exactly like ``std::istringstream``
tolerates them (it simply stops reading numbers at the first non-numeric
token). The image transform is ``rotate(angle, axis) @ scale(voxel_size *
extent)`` (reference: src/load_volume.cpp:81-83).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..utils import math3d

_DTYPES = {
    "uint8_t": np.uint8,
    "int8_t": np.int8,
    "uint16_t": np.uint16,
    "int16_t": np.int16,
}


@dataclasses.dataclass
class Header:
    """Parsed volume header.

    ``extent`` is (width, height, depth) in voxels — i.e. (x, y, z) — matching
    the reference's ``VkExtent3D``; the in-memory array shape is
    ``(depth, height, width)`` (z-major C order, the raw file layout).
    """

    extent: tuple[int, int, int]          # (W, H, D)
    voxel_size: tuple[float, float, float]
    normalisation_range: tuple[float, float]
    dtype: str                            # uint8_t | int8_t | uint16_t | int16_t
    endianness: str                       # "little" | "big"
    rotation_axis: tuple[float, float, float]
    rotation_angle_deg: float

    @property
    def shape_zyx(self) -> tuple[int, int, int]:
        w, h, d = self.extent
        return (d, h, w)

    @property
    def n_voxels(self) -> int:
        w, h, d = self.extent
        return w * h * d

    @property
    def np_dtype(self) -> np.dtype:
        base = np.dtype(_DTYPES[self.dtype])
        return base.newbyteorder("<" if self.endianness == "little" else ">")

    @property
    def image_transform(self) -> np.ndarray:
        """``rotate(radians(angle), axis) @ scale(voxel_size * extent)``
        (reference: src/load_volume.cpp:81-83)."""
        physical = np.asarray(self.voxel_size, np.float32) * np.asarray(
            self.extent, np.float32
        )
        return math3d.rotate(
            np.deg2rad(self.rotation_angle_deg), self.rotation_axis
        ) @ math3d.scale(physical)


def _nums(line: str, n: int, cast):
    """Read up to ``n`` leading numeric tokens, istringstream-style."""
    out = []
    for tok in line.split():
        try:
            out.append(cast(tok))
        except ValueError:
            break
        if len(out) == n:
            break
    if len(out) != n:
        raise ValueError(f"expected {n} values in header line: {line!r}")
    return out


def parse_header(text: str) -> Header:
    lines = text.splitlines()
    if len(lines) < 5:
        raise ValueError("header must have 5 lines")
    extent = _nums(lines[0], 3, int)
    voxel_size = _nums(lines[1], 3, float)
    norm = _nums(lines[2], 2, float)
    toks = lines[3].split()
    if len(toks) < 2:
        raise ValueError(f"bad dtype/endianness line: {lines[3]!r}")
    dtype, endianness = toks[0], toks[1]
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported image data type: {dtype!r}")
    if endianness not in ("little", "big"):
        raise ValueError(f"unsupported endianness: {endianness!r}")
    aa = _nums(lines[4], 4, float)
    return Header(
        extent=tuple(extent),
        voxel_size=tuple(voxel_size),
        normalisation_range=tuple(norm),
        dtype=dtype,
        endianness=endianness,
        rotation_axis=tuple(aa[:3]),
        rotation_angle_deg=aa[3],
    )


def load_header(path: str | os.PathLike) -> Header:
    with open(path, "r") as f:
        return parse_header(f.read())


def write_header(path: str | os.PathLike, h: Header) -> None:
    """Write a header in the reference grammar (round-trip helper)."""
    with open(path, "w") as f:
        f.write(f"{h.extent[0]} {h.extent[1]} {h.extent[2]} # extents\n")
        f.write(
            f"{h.voxel_size[0]} {h.voxel_size[1]} {h.voxel_size[2]} # voxel size\n"
        )
        f.write(
            f"{h.normalisation_range[0]} {h.normalisation_range[1]} # normalisation range\n"
        )
        f.write(f"{h.dtype} {h.endianness} # data type and endianness (big or little)\n")
        ax = h.rotation_axis
        f.write(
            f"{ax[0]} {ax[1]} {ax[2]} {h.rotation_angle_deg} # rotation axis and angle (degrees)\n"
        )
