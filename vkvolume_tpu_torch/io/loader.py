"""Raw binary volume loading + normalisation to uint8.

The JAX package's ``vkvolume_tpu/io/loader.py``, unchanged: host numpy
(and ctypes) only, shared by both packages' file formats.

Mirrors the behaviour of ``LoadVolume::load_data`` (reference:
src/load_volume.cpp:88-172): read the densely-packed raw file, swap to native
endianness, then linearly normalise into uint8 with

    u8 = uint8( 255 * clamp((v - lo) / (hi - lo), 0, 1) )

where the final cast *truncates* (C++ ``static_cast<uint8_t>`` semantics,
reference: src/load_volume.cpp:168-169).

A native C++ loader (``native/loader.cpp``, multithreaded single-pass
read+swap+normalise) is used when its shared library has been built;
otherwise a numpy path with identical results is used.
"""

from __future__ import annotations

import os

import numpy as np

from .header import Header, load_header
from . import native


def normalise_to_u8(data: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """Exact reference normalisation (src/load_volume.cpp:164-169)."""
    v = data.astype(np.float32)
    t = np.clip((v - np.float32(lo)) / (np.float32(hi) - np.float32(lo)), 0.0, 1.0)
    # C++ static_cast<uint8_t> truncates toward zero.
    return (np.float32(255.0) * t).astype(np.uint8)


def load_data(path: str | os.PathLike, header: Header) -> np.ndarray:
    """Load + normalise the raw volume; returns uint8 array of shape (D, H, W)."""
    expected = header.n_voxels * header.np_dtype.itemsize
    actual = os.path.getsize(path)
    if actual != expected:
        raise ValueError(
            "File size does not match expected size for the given image "
            f"format/dimensions (got {actual}, expected {expected})"
        )
    lo, hi = header.normalisation_range
    out = native.load_normalised(path, header)
    if out is None:
        raw = np.fromfile(path, dtype=header.np_dtype, count=header.n_voxels)
        out = normalise_to_u8(raw, lo, hi)
    return out.reshape(header.shape_zyx)


def load_volume(path: str | os.PathLike) -> tuple[np.ndarray, Header]:
    """Load ``<path>`` with its ``<path>.header`` sidecar.

    Equivalent of ``Volume::load_from_file``'s IO portion (reference:
    src/volume_component.cpp:55-63).
    """
    header = load_header(str(path) + ".header")
    return load_data(path, header), header


def save_volume(path: str | os.PathLike, data: np.ndarray, header: Header) -> None:
    """Write a raw volume + header (used by tests and dataset synthesis)."""
    from .header import write_header

    data.astype(header.np_dtype).tofile(path)
    write_header(str(path) + ".header", header)
